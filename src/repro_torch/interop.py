"""Parameter trees: walking them, and carrying the reference's weights over.

``params_from_jax`` takes a parameter tree of the JAX package as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree
with the same structure, shapes and dtypes, so both packages compute on the
same weights. It imports neither ``jax`` nor ``repro``: dicts are walked by
key and NamedTuples by ``_fields``, matched to the port's classes by name.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.layers.attention import AttnParams
from repro_torch.layers.mlp import MlpParams
from repro_torch.layers.rwkv import RwkvChannelMixParams, RwkvTimeMixParams

_NAMED = {cls.__name__: cls for cls in (
    AttnParams, MlpParams, RwkvTimeMixParams, RwkvChannelMixParams)}


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


def params_from_jax(tree: Any, cfg, device) -> Any:
    """The reference's parameter tree (numpy leaves) as the port's tree on
    ``device``. Raises if it does not match what ``init_lm(cfg)`` makes."""
    from repro_torch import models

    params = _convert(tree, device)
    want = dict(tree_items(models.init(cfg, device="meta")))
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
