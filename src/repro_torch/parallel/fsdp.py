"""The sharded training step's gather and reduce plan (the reference's
stated FSDP rule: "weights gathered over 'data' per layer").

Each rank stores only its blocks of the parameters (``param_specs``). The
forward gathers a stacked leaf's layer slice just before the layer uses it
(``layers.common.gathered``, called by the models at their one slice per
layer, inside the remat boundary, so the recompute gathers again); the
embedding, unembedding, norms and any other unstacked leaf are gathered
once a step by the train step. A gather is :class:`Gather`, an autograd
Function whose backward reduces the gradient (:func:`reduce_grad`): over a
DP axis the leaf is split on, a reduce-scatter; over a DP axis it is not,
an all-reduce; then the mean over the DP extent; over 'model', this rank's
slice (every rank along 'model' computed the same whole leaf).

Tensor parallelism: a leaf of an attention or MLP block (``AttnParams``,
``MlpParams``), RWKV-6's time-mix projections (``wr``, ``wk``, ``wv``,
``wg``, ``wo``) and channel-mix FFN (``wk``, ``wv``), Mamba-2's
``w_in``, ``w_out`` and ``norm_g``, and the vocab-split embedding and
unembedding keep their 'model' block. They are gathered over the DP axes
only, marked (``core.distributed.mark_model_block``) and consumed as
blocks by the layers (column- and row-parallel products, the
vocab-parallel lookup, unembedding and loss): their gradient is already
this rank's block, so ``reduce_grad`` takes no slice over 'model' for
them. Any other leaf (RWKV-6's LoRA towers, per-channel vectors and
channel-mix ``wr``; Mamba-2's conv and per-head vectors) is gathered
whole as before; a layer that does not split its heads over 'model'
gathers its blocks too (``layers.common.model_whole``).

Expert parallelism: a MoE expert table (a leaf with the logical axis
'expert', split over 'data') is gathered over nothing. Each rank computes
with its (E / D, d, f / TP) block (``layers.moe``), its 'model' block
marked where 'model' splits it. Its gradient takes no reduction over
'data' (the backward all-to-all already brought every rank's
contribution to the expert's owner): it is summed over the other DP axes
('pod', over which the tables are replicated) and divided by the whole DP
extent, as every other gradient is (:class:`ExpertBlock`). The router
stays a gathered leaf.

With a mesh whose every extent is 1 nothing is gathered or reduced and no
Function is inserted: the step is the one-device step, bit for bit.
"""
from __future__ import annotations

import copy
import math

import torch

from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context, use_context
from repro_torch.interop import tree_items, tree_map_with_path
from repro_torch.layers.attention import AttnParams
from repro_torch.layers.mamba import MambaParams
from repro_torch.layers.mlp import MlpParams
from repro_torch.layers.moe import MoeParams
from repro_torch.layers.rwkv import RwkvChannelMixParams, RwkvTimeMixParams
from repro_torch.parallel import sharding as shd

# the top-level leaves split over 'vocab', consumed vocab-parallel
VOCAB_LEAVES = ("embed", "unembed")


def stacked_keys(axes) -> set[str]:
    """The top-level subtrees whose every leaf is stacked on a leading
    'layers' dim: the models gather those a layer slice at a time."""
    return {k for k, a in axes.items()
            if all(ax[:1] == ("layers",) for _, ax in tree_items(a))}


def _paths(specs, enters, path: str = "", inside: bool = False):
    """The paths of the leaves inside a field that ``enters(container,
    field)`` names (and every leaf below it)."""
    if specs is None:
        return
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _paths(v, enters, join(k), inside)
    elif hasattr(specs, "_fields") and not isinstance(specs,
                                                      shd.PartitionSpec):
        for f, v in zip(specs._fields, specs):
            yield from _paths(v, enters, join(f), inside or enters(specs, f))
    elif inside:
        yield path


# the fields of the other layers' parameter tuples that the layers consume
# as 'model' blocks
TP_FIELDS = {RwkvTimeMixParams: {"wr", "wk", "wv", "wg", "wo"},
             RwkvChannelMixParams: {"wk", "wv"},
             MambaParams: {"w_in", "w_out", "norm_g"}}


def _tp_paths(specs):
    """The paths of the leaves inside an attention or MLP block, and of
    the :data:`TP_FIELDS` leaves."""
    return _paths(specs, lambda c, f: isinstance(c, (AttnParams, MlpParams))
                  or f in TP_FIELDS.get(type(c), ()))


def _expert_paths(specs):
    """The paths of the MoE expert tables' leaves (every leaf of a
    ``MoeParams``' ``w_in``, ``w_gate`` and ``w_out``, a pre-quantized
    table's int8 weights and scales included)."""
    return _paths(specs, lambda c, f: isinstance(c, MoeParams)
                  and f != "w_router")


def model_dim(spec, mesh) -> int | None:
    """The dim ``spec`` splits over 'model' (extent above 1), or None."""
    if mesh.axis_size("model") == 1:
        return None
    return next((d for d, e in enumerate(spec)
                 if "model" in cd.entry_axes(e)), None)


def without_model(spec) -> shd.PartitionSpec:
    """``spec`` with 'model' taken out of every entry."""
    def entry(e):
        names = tuple(n for n in cd.entry_axes(e) if n != "model")
        return None if not names else names[0] if len(names) == 1 else names

    return shd.P(*(entry(e) for e in spec))


def reduce_grad(g: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The gradient of a gathered (whole) leaf, summed on each rank over its
    own rows, as this rank's block of the mean over the DP axes: first this
    rank's slice over every axis but the DP ones (no collective), then a
    reduce-scatter over each DP axis the leaf is split on, an all-reduce
    over the others. ``g`` is not written."""
    dp = mesh.dp_axes()
    split = [(dim, name) for dim, entry in enumerate(spec)
             for name in cd.entry_axes(entry) if mesh.axis_size(name) > 1]
    for dim, name in split:
        if name not in dp:
            g = cd.local_block(g, dim, mesh, name)
    fresh = False
    for dim, name in split:  # major axis first
        if name in dp:
            g, fresh = cd.reduce_scatter(g, mesh, name, dim), True
    rest = [a for a in dp if a not in {n for _, n in split}
            and mesh.axis_size(a) > 1]
    n = math.prod(mesh.axis_size(a) for a in dp)
    if (rest or n > 1) and not fresh:
        g = g.clone(memory_format=torch.contiguous_format)
    g = cd.all_reduce(g, mesh, rest)
    return g.div_(n) if n > 1 else g


class Gather(torch.autograd.Function):
    """The whole leaf from this rank's block; backward :func:`reduce_grad`.
    The backward runs under the forward's GEMM context (mesh, plan and
    collective counter): autograd runs the backward of CUDA tensors on a
    device thread of its own, which the context variable does not reach."""

    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        ctx.gemm_context = current_context()
        full = shd.gather_leaf(local, spec, mesh)
        return local.view_as(local) if full is local else full

    @staticmethod
    def backward(ctx, g):
        with use_context(ctx.gemm_context):
            return reduce_grad(g, ctx.spec, ctx.mesh), None, None


class ExpertBlock(torch.autograd.Function):
    """An expert table's block as it is; backward the gradient summed over
    the DP axes other than 'data' and divided by the DP extent (the module
    docstring), under the forward's GEMM context."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh, ctx.gemm_context = mesh, current_context()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        dp = mesh.dp_axes()
        n = math.prod(mesh.axis_size(a) for a in dp)
        with use_context(ctx.gemm_context):
            g = cd.all_reduce(g.clone(memory_format=torch.contiguous_format),
                              mesh, [a for a in dp if a != "data"])
        return g.div_(n), None


class ShardPlan:
    """What a sharded step gathers: ``mesh`` and the parameter spec tree.
    ``blocked``: the paths of the leaves that keep their 'model' block
    (empty when 'model' has extent 1); ``experts``: the paths of the MoE
    expert tables, which keep their blocks (empty on a mesh whose every
    extent is 1). ``kv``: the spec of the decode state's stacked K leaf
    (``decode_state_specs``, an entry for each dim; None: not given), by
    which the attention layers read how the KV cache lies over the DP axes
    (the engine's lanes or the cache's sequence, a pool's blocks) and
    'model' (a contiguous cache's sequence). ``rows_whole``: the step's
    rows are every rank's, not this rank's over the DP axes (an engine's
    chunk or admission, lanes the DP extent does not divide), which the
    MoE block splits over 'data' itself."""

    def __init__(self, mesh, specs, kv=None):
        self.mesh, self.specs, self.kv = mesh, specs, kv
        self.rows_whole = False
        self.dp_size = math.prod(mesh.axis_size(a) for a in mesh.dp_axes())
        self.tp = mesh.axis_size("model")
        self.blocked = set()
        if self.tp > 1:
            self.blocked = set(_tp_paths(specs)) | {
                k for k in VOCAB_LEAVES if k in specs}
        self.experts = set()
        if any(n > 1 for n in mesh.shape):
            self.experts = set(_expert_paths(specs))

    def with_kv(self, kv) -> "ShardPlan":
        """This plan over a decode state whose K leaf lies by ``kv``."""
        out = copy.copy(self)
        out.kv = kv
        return out

    def with_rows_whole(self, whole: bool) -> "ShardPlan":
        """This plan for a step whose rows are every rank's (``whole``) or
        this rank's over the DP axes."""
        if whole == self.rows_whole:
            return self
        out = copy.copy(self)
        out.rows_whole = whole
        return out

    def trivial(self, spec) -> bool:
        """Nothing to gather and nothing to reduce."""
        return self.dp_size == 1 and not shd.is_sharded(spec, self.mesh)

    def split(self, path: str, spec):
        """(the spec to gather the leaf at ``path`` by, the dim it keeps
        split over 'model' or None)."""
        dim = model_dim(spec, self.mesh) if path in self.blocked else None
        return (spec if dim is None else without_model(spec)), dim

    def gather(self, local: torch.Tensor, spec, path: str = ""
               ) -> torch.Tensor:
        if path in self.experts:
            out = ExpertBlock.apply(local, self.mesh) if self.dp_size > 1 \
                else local.view_as(local)
            dim = model_dim(spec, self.mesh)
            return out if dim is None else cd.mark_model_block(out, dim)
        spec, dim = self.split(path, spec)
        out = local if self.trivial(spec) else \
            Gather.apply(local, spec, self.mesh)
        if dim is None:
            return out
        return cd.mark_model_block(
            local.view_as(local) if out is local else out, dim)

    def tops(self, params, stacked) -> dict:
        """``params`` with every leaf outside the ``stacked`` subtrees
        gathered as :meth:`gather` does (the serve steps: once a call, no
        gradient)."""
        out = {}
        for k, sub in params.items():
            if k in stacked:
                out[k] = sub
                continue
            spec_of = dict(tree_items(self.specs[k]))
            out[k] = tree_map_with_path(
                lambda p, t: self.gather(t, spec_of[p],
                                         f"{k}/{p}" if p else k), sub)
        return out

    def layer(self, lp, path: str, lead: int = 1):
        """One layer's slice of the stacked subtree at ``path`` ('layers',
        'encoder', 'groups/self', ...), whole: its specs are the stacked
        leaves' without their ``lead`` stack dims (never split: the
        'layers' rule is None)."""
        specs = self.specs
        for k in path.split("/"):
            specs = specs[k]
        spec_of = dict(tree_items(specs))

        def one(leaf_path, t):
            spec = spec_of[leaf_path]
            if any(e is not None for e in spec[:lead]):
                raise ValueError(f"a stacked leaf of {path} is split on its "
                                 f"stack dims: {spec}")
            return self.gather(t, shd.P(*spec[lead:]),
                               f"{path}/{leaf_path}")

        return tree_map_with_path(one, lp)
