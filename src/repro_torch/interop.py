"""Parameter trees: walking them, and carrying the reference's weights over.

``params_from_jax`` takes a parameter tree of the JAX package as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree
with the same structure, shapes and dtypes, so both packages compute on the
same weights. It imports neither ``jax`` nor ``repro``: dicts are walked by
key and NamedTuples by ``_fields``, matched to the port's classes by name.
A pre-quantized tree (the reference's ``quant.prequant.quantize_params``,
whose ``QuantizedLinear`` leaves carry ``bias=None``) converts leaf for leaf
into the port's ``QuantizedLinear``. ``state_from_jax`` does the same for
a training state (params, optimizer state and step), so that both packages
can train on from one state; ``shard_state`` then lays such a tree out per
rank for a sharded step.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.layers.attention import AttnParams
from repro_torch.layers.mamba import MambaParams
from repro_torch.layers.mlp import MlpParams
from repro_torch.layers.moe import MoeParams
from repro_torch.layers.rwkv import RwkvChannelMixParams, RwkvTimeMixParams
from repro_torch.quant.int8 import QuantizedLinear

_NAMED = {cls.__name__: cls for cls in (
    AttnParams, MambaParams, MlpParams, MoeParams, RwkvTimeMixParams,
    RwkvChannelMixParams, QuantizedLinear)}


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and NamedTuples;
    ``None`` is an empty subtree and stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """:func:`tree_map` with ``fn(path, leaf)``, paths as
    :func:`tree_items` gives them."""
    if tree is None:
        return None
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, join(f))
                            for f, v in zip(tree._fields, tree)))
    return fn(prefix, tree)


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order; paths join keys and field names
    with '/'. ``None`` subtrees yield nothing."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_items(v, f"{prefix}/{k}" if prefix else str(k))


def tree_zip(tree: Any, *others: Any) -> Iterator[tuple]:
    """For each leaf of ``tree`` (in :func:`tree_items` order): the leaf and
    the node of each of ``others`` at the same place, a leaf or a subtree
    (an optimizer's per-leaf dict of moments)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_zip(v, *(o[k] for o in others))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from tree_zip(getattr(tree, f),
                                *(getattr(o, f) for o in others))
    else:
        yield (tree, *others)


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a torch tensor."""
    arr = np.array(arr, copy=True, order="C")  # writable: torch shares it
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _convert(node: Any, device) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if hasattr(node, "_fields"):
        name = type(node).__name__
        if name not in _NAMED:
            raise TypeError(f"no port class for NamedTuple {name!r}")
        cls = _NAMED[name]
        return cls(*(_convert(getattr(node, f), device) for f in cls._fields))
    return to_tensor(np.asarray(node), device)


def is_quantized(tree: Any) -> bool:
    """Whether a parameter tree holds a pre-quantized leaf
    (``QuantizedLinear``)."""
    if isinstance(tree, QuantizedLinear):
        return True
    if isinstance(tree, dict):
        return any(is_quantized(v) for v in tree.values())
    return hasattr(tree, "_fields") and any(is_quantized(v) for v in tree)


def params_from_jax(tree: Any, cfg, device) -> Any:
    """The reference's parameter tree (numpy leaves) as the port's tree on
    ``device``. Raises if it does not match what ``models.init(cfg)``
    makes (every family: the vision family's two-level stacks and (G,)
    gates too), or, for a pre-quantized tree, what
    ``quantize_params(models.init(cfg))`` makes (both traced on the meta
    device)."""
    from repro_torch import models
    from repro_torch.quant.prequant import quantize_params

    params = _convert(tree, device)
    shapes = models.init(cfg, device="meta")
    if is_quantized(params):
        shapes = quantize_params(shapes)
    want = dict(tree_items(shapes))
    got = dict(tree_items(params))
    if want.keys() != got.keys():
        raise ValueError(f"tree mismatch: missing {sorted(want - got.keys())},"
                         f" extra {sorted(got.keys() - want)}")
    for path, t in got.items():
        w = want[path]
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"{cfg.name} wants {tuple(w.shape)} {w.dtype}")
    return params


def state_from_jax(tree: Any, cfg, device) -> dict[str, Any]:
    """The reference's training state ``{"params", "opt", "step"}`` (numpy
    leaves) as the port's on ``device``: the params checked as in
    :func:`params_from_jax`, the optimizer state's trees (AdamW's ``m`` and
    ``v``, Adafactor's per-leaf dicts) converted leaf for leaf, the step a
    0-d int32 tensor."""
    return {"params": params_from_jax(tree["params"], cfg, device),
            "opt": _convert(tree["opt"], device),
            "step": to_tensor(np.asarray(tree["step"], dtype=np.int32),
                              device)}


def shard_state(state: Any, specs: Any, mesh, *, cfg=None) -> Any:
    """A whole tree (a state carried across from JAX, or a checkpoint's) laid
    out for this rank: each leaf's block of its spec on ``mesh``
    (``parallel.sharding.shard_leaf``; a leaf the spec does not split is
    kept as it is). ``specs`` None: ``state`` is a decode state of
    ``cfg``, laid out by ``decode_state_specs`` (its paged rules for a
    ``PagedKVCache`` pool)."""
    from repro_torch.layers.attention import PagedKVCache
    from repro_torch.parallel.sharding import decode_state_specs, shard_tree

    if specs is None:
        paged = isinstance(state, dict) and any(
            isinstance(v, PagedKVCache) for v in state.values())
        specs = decode_state_specs(state, cfg, mesh, paged=paged)
    return shard_tree(state, specs, mesh)
