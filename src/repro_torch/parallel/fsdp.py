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
slice (ranks along 'model' compute the same rows in this slice: the axis
shards storage, not compute; tensor-parallel compute is the next slice).

With a mesh whose every extent is 1 nothing is gathered or reduced and no
Function is inserted: the step is the one-device step, bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context, use_context
from repro_torch.interop import tree_items, tree_map_with_path
from repro_torch.parallel import sharding as shd


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


class ShardPlan:
    """What a sharded step gathers: ``mesh`` and the parameter spec tree."""

    def __init__(self, mesh, specs):
        self.mesh, self.specs = mesh, specs
        self.dp_size = math.prod(mesh.axis_size(a) for a in mesh.dp_axes())

    def trivial(self, spec) -> bool:
        """Nothing to gather and nothing to reduce."""
        return self.dp_size == 1 and not shd.is_sharded(spec, self.mesh)

    def gather(self, local: torch.Tensor, spec) -> torch.Tensor:
        if self.trivial(spec):
            return local
        return Gather.apply(local, spec, self.mesh)

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
            return self.gather(t, shd.P(*spec[lead:]))

        return tree_map_with_path(one, lp)
