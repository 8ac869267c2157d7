"""Pre-quantized parameter trees: quantize weights once at load (port of
``repro.quant.prequant``).

``quantize_params`` walks a parameter tree once and replaces every
projection weight of the port's containers with a
:class:`repro_torch.quant.int8.QuantizedLinear` (int8 (N, K) weights and
per-channel scales), so decode streams int8 weights and the dequantize
rides the GEMM epilogue. ``layers.common.dense`` dispatches on the leaf
type, so no model code changes. Biases stay in their own fields; every
other leaf (embeddings, norms, the unembed, RWKV's LoRA towers and mixing
coefficients) stays float, and under ``quant_mode="int8"`` a float weight
takes the dynamic path (re-quantized at every call), as in the reference.

Stacked layer leaves (L, K, N) quantize per layer: each layer gets its own
per-output-channel scales, as the reference's vmap over the layer axis
gives; the vision family's two-level leaves (G, n_self, K, N) per group
and layer, as its vmap over both stack axes gives (the (G,) cross gates
stay float). MoE expert tables (L, E, d, f) / (L, E, f, d) quantize per layer
and expert the same way, and ``moe_ffn`` dequantizes them at every call;
the router stays float (under ``quant_mode="int8"`` it takes the dynamic
path). Mamba quantizes its in and out projections; the conv and SSM
coefficients are elementwise state math and stay float.

``quantize_axes`` transforms a logical-axes tree in lockstep, so that
``parallel.sharding.param_specs`` lays out a quantized tree too: the (K, N)
-> (N, K) transpose swaps a projection's two logical axes, and its scales
take the output axis.
"""
from __future__ import annotations

from typing import Any

from repro_torch.layers.attention import AttnParams
from repro_torch.layers.mamba import MambaParams
from repro_torch.layers.mlp import MlpParams
from repro_torch.layers.moe import MoeParams
from repro_torch.layers.rwkv import RwkvChannelMixParams, RwkvTimeMixParams
from repro_torch.quant.int8 import QuantizedLinear, quantize_linear

# Which fields of which containers are GEMM projection weights: RWKV
# time-mix quantizes its five (d, d) stream projections and channel-mix its
# three; the LoRA mix/decay towers stay float.
_PROJECTION_FIELDS: dict[type, tuple[str, ...]] = {
    AttnParams: ("wq", "wk", "wv", "wo"),
    MlpParams: ("w_in", "w_gate", "w_out"),
    MoeParams: ("w_in", "w_gate", "w_out"),
    RwkvTimeMixParams: ("wr", "wk", "wv", "wg", "wo"),
    RwkvChannelMixParams: ("wk", "wv", "wr"),
    MambaParams: ("w_in", "w_out"),
}


def _map_projections(tree: Any, leaf_fn) -> Any:
    """Apply ``leaf_fn`` to every projection-weight field, leaving biases
    and every other leaf untouched."""
    def rec(node):
        fields = _PROJECTION_FIELDS.get(type(node))
        if fields is not None:
            return node._replace(**{
                f: leaf_fn(getattr(node, f))
                for f in fields if getattr(node, f) is not None})
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return node

    return rec(tree)


def quantize_params(params: Any) -> Any:
    """The tree with every projection weight a ``QuantizedLinear`` (bias
    None; biases stay where they are). The float projections are no longer
    referenced by the result, so dropping the input frees them."""
    return _map_projections(params, quantize_linear)


def _axes_for_weight(axes: tuple) -> QuantizedLinear:
    """Logical axes (*stack, K-axis, N-axis) -> the quantized leaf's."""
    *stack, ak, an = axes
    return QuantizedLinear(w_q=(*stack, an, ak), w_scale=(*stack, an),
                           bias=None)


def quantize_axes(axes: Any) -> Any:
    """A logical-axes tree transformed in lockstep with
    :func:`quantize_params`."""
    return _map_projections(axes, _axes_for_weight)
