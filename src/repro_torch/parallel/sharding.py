"""Logical-axis partitioning: axes trees -> partition specs (port of
``repro.parallel.sharding``).

Rules (the mesh rendition of the paper's array mapping):

  embed  -> data    FSDP: weights gathered over 'data' per layer
  ffn/heads/kv/vocab -> model    Megatron TP (column/row parallel pairs)
  expert -> data    EP: experts live where the tokens' DP shard is
  layers/lora/conv/state -> None (the stacked layer dim is never sharded)

Conflict resolution: a mesh axis may appear once per spec: the first
(leftmost) logical axis wins, later claims degrade to None. Divisibility:
a dim that the mesh axis extent does not divide degrades to None (tiny
smoke configs). Trailing Nones are trimmed.

A spec is the port's own :class:`PartitionSpec`, a tuple of entries (an
axis name, a tuple of names, or None), one per leading dim. The mesh is
:class:`repro_torch.launch.mesh.Mesh`. Beyond the reference's rules this
module lays leaves out per rank: :func:`local_shape`, :func:`shard_leaf`
(this rank's block, a copy) and :func:`gather_leaf` (the whole leaf back,
by all-gathers over the spec's axes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import distributed as cd
from repro_torch.interop import tree_items, tree_map, tree_map_with_path
from repro_torch.models.lm import is_axes_leaf

DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "embed": "data",
    "ffn": "model",
    "heads": "model",
    "kv": "model",
    "vocab": "model",
    "expert": "data",
    "layers": None,
    "lora": None,
    "conv": None,
    "state": None,
}


class PartitionSpec(tuple):
    """One leaf's layout: an entry per leading dim, an axis name, a tuple
    of names (major first) or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: how one leaf lies across the ranks."""

    mesh: Any
    spec: PartitionSpec


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The DP axes: ('pod', 'data') on multi-pod meshes, ('data',)
    otherwise."""
    return mesh.dp_axes()


def spec_for(axes: tuple | None, shape, mesh, rules: dict | None = None
             ) -> PartitionSpec:
    """One param leaf: logical axes tuple + concrete shape -> spec."""
    if axes is None:
        return P()
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.get(logical) if logical is not None else None
        if mesh_axis is None or mesh_axis not in sizes:
            entries.append(None)
            continue
        if mesh_axis in used or dim % sizes[mesh_axis] != 0:
            entries.append(None)
            continue
        used.add(mesh_axis)
        entries.append(mesh_axis)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _zip_axes(axes, node, fn, path: str = ""):
    """Walk a param (or shape) tree and its axes tree in lockstep: ``fn(axes
    leaf, leaf)`` at every leaf; raises where the two trees differ."""
    if node is None:
        return None
    if isinstance(node, dict):
        if not isinstance(axes, dict) or set(axes) != set(node):
            raise ValueError(f"axes tree does not match param tree at "
                             f"{path or '/'}: {_keys(axes)} vs {sorted(node)}")
        return {k: _zip_axes(axes[k], v, fn, f"{path}/{k}")
                for k, v in node.items()}
    if hasattr(node, "_fields"):
        if getattr(axes, "_fields", None) != node._fields:
            raise ValueError(f"axes tree does not match param tree at "
                             f"{path}: {type(axes).__name__} vs "
                             f"{type(node).__name__}")
        return type(node)(*(_zip_axes(getattr(axes, f), getattr(node, f),
                                      fn, f"{path}/{f}")
                            for f in node._fields))
    if not is_axes_leaf(axes):
        raise ValueError(f"axes tree does not match param tree at {path}: "
                         f"{axes!r} for a leaf")
    return fn(axes, node)


def _keys(axes):
    return sorted(axes) if isinstance(axes, dict) else type(axes).__name__


def param_specs(axes_tree, shape_tree, mesh, rules=None):
    """Full trees: axes tree (logical) + shapes (tensors, meta or not) ->
    a tree of specs shaped like ``shape_tree``."""
    return _zip_axes(axes_tree, shape_tree,
                     lambda a, x: spec_for(a, tuple(x.shape), mesh, rules))


def named_shardings(specs, mesh):
    """A spec tree as a tree of :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def _dp_entry(mesh):
    dp = data_axes(mesh)
    return (dp if len(dp) > 1 else dp[0]) if dp else None


def batch_specs(batch_shapes: dict, mesh) -> dict:
    """Input batch: leading (batch) dim over the DP axes when divisible."""
    dp = data_axes(mesh)
    dp_total = math.prod(mesh.axis_size(a) for a in dp)
    entry = _dp_entry(mesh)

    def spec(x):
        if x.ndim == 0:
            return P()
        if dp and x.shape[0] % dp_total == 0 and x.shape[0] > 0:
            return P(entry, *([None] * (x.ndim - 1)))
        return P(*([None] * x.ndim))

    return {k: spec(v) for k, v in batch_shapes.items()}


def _trim(entries: list) -> PartitionSpec:
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def decode_state_specs(state_shapes, cfg, mesh, paged: bool = False):
    """Decode-state layout, the reference's rules. KV caches: batch over DP
    when divisible, else the *sequence* dim over 'data' (long_500k: batch
    1, a 512k cache), heads over 'model' with the GQA fallbacks (head_dim,
    then sequence); the per-slot length vector replicated. ``paged``: the
    pool's block axis over DP, heads over 'model' (head_dim as the
    fallback), the block table replicated, the int8 pool's (L, blocks,
    Hkv) scales riding the pool's rule. Context tensors ('enc', 'img'):
    batch over DP. Other states (L, B, ...): batch over DP, dim 2 over
    'model' when it divides."""
    sizes = mesh_axis_sizes(mesh)
    dp_total = math.prod(mesh.axis_size(a) for a in data_axes(mesh))
    model = sizes.get("model", 1)
    dp_entry = _dp_entry(mesh)

    def spec(keyname: str, x) -> PartitionSpec:
        shape = tuple(x.shape)
        nd = len(shape)
        if nd == 0:
            return P()
        if "kv" in keyname and nd == 1:
            return P()  # per-slot length vector: replicated
        if paged and "kv" in keyname:
            if nd == 2:
                return P()  # block table: replicated routing metadata
            entries = [None] * nd
            if shape[1] % dp_total == 0 and dp_entry is not None:
                entries[1] = dp_entry
            if nd == 3:  # int8-pool scales (L, num_blocks, Hkv)
                if model > 1 and shape[2] % model == 0:
                    entries[2] = "model"
            elif model > 1:  # (L, num_blocks, block_size, H, D) pool
                if shape[3] % model == 0:
                    entries[3] = "model"
                elif shape[4] % model == 0:
                    entries[4] = "model"
            return _trim(entries)
        entries = [None] * nd
        if keyname.split("/")[0] in ("enc", "img"):
            if shape[0] % dp_total == 0 and dp_entry is not None:
                entries[0] = dp_entry
        elif "kv" in keyname and nd >= 4:
            # (L, B, S, H, D) or (G, n, B, S, H, D)
            b_dim, s_dim, h_dim, d_dim = nd - 4, nd - 3, nd - 2, nd - 1
            if shape[b_dim] % dp_total == 0 and dp_entry is not None:
                entries[b_dim] = dp_entry
            elif "data" in sizes and shape[s_dim] % sizes["data"] == 0:
                entries[s_dim] = "data"  # sequence-sharded cache
            if model > 1:
                if shape[h_dim] % model == 0:
                    entries[h_dim] = "model"
                elif shape[d_dim] % model == 0:
                    entries[d_dim] = "model"
                elif entries[s_dim] is None and shape[s_dim] % model == 0:
                    entries[s_dim] = "model"
        elif nd >= 2:
            if shape[1] % dp_total == 0 and dp_entry is not None:
                entries[1] = dp_entry
            if nd >= 3 and shape[2] % model == 0 and model > 1:
                entries[2] = "model"
        return _trim(entries)

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f),
                                     f"{path}/{f}" if path else f)
                                for f in node._fields))
        return spec(path, node)

    return walk(state_shapes, "")


# ------------------------------------------------------------ per rank
def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` laid out by
    ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = cd.axes_extent(mesh, entry)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {entry} ({n})")
        out[dim] //= n
    return tuple(out)


def local_bytes(x, spec, mesh) -> int:
    """The bytes of one rank's block of tensor ``x`` (meta or not)."""
    return math.prod(local_shape(tuple(x.shape), spec, mesh)) * \
        x.element_size()


def is_sharded(spec, mesh) -> bool:
    return any(cd.axes_extent(mesh, e) > 1 for e in spec)


def shard_leaf(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full``: a copy (so that the whole leaf can
    be freed), or ``full`` itself where ``spec`` splits nothing."""
    if not is_sharded(spec, mesh):
        return full
    out = full
    for dim, entry in enumerate(spec):
        n = cd.axes_extent(mesh, entry)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {entry} ({n})")
        size = out.shape[dim] // n
        out = out.narrow(dim, cd.entry_index(mesh, entry) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_leaf(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block: an all-gather over each axis
    of ``spec`` (minor axis of a combined entry first), through the counted
    helpers. ``local`` itself where ``spec`` splits nothing."""
    out = local
    for dim, entry in enumerate(spec):
        for name in reversed(cd.entry_axes(entry)):
            out = cd.all_gather(out, mesh, name, dim)
    return out if out is local else out.contiguous()


def shard_tree(tree, specs, mesh):
    """:func:`shard_leaf` over a tree, each leaf by the spec at its path in
    ``specs``."""
    spec_of = dict(tree_items(specs))
    return tree_map_with_path(
        lambda p, t: shard_leaf(t, spec_of[p], mesh), tree)
