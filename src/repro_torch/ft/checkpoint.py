"""Checkpointing: atomic, async (port of ``repro.ft.checkpoint``).

Layout, the reference's: ``<dir>/step_<N>/`` with one ``.npy`` per leaf
(path-encoded file names: the tree's keys and field names joined by
``__``) and ``manifest.json`` (step, and each leaf's key, shape and dtype).
Writes go to ``step_<N>.tmp``, which is renamed atomically: a crash
mid-write never corrupts the latest checkpoint. The newest 3 are kept.
``AsyncCheckpointer`` copies the state to host memory synchronously and
writes it on a background thread, so the train loop never waits on disk.

A bf16 leaf is stored as its ``uint16`` bits (numpy has no bfloat16 here)
with ``bfloat16`` in the manifest; restore reads those bits back, or an
f32 file (the reference's way of storing bf16), and casts to the target
leaf's dtype. Restore takes the target tree (the state, or its shapes on
the meta device) and a device, and raises on a shape mismatch.

Sharded (``shardings``: a tree of ``parallel.sharding.NamedSharding`` like
the state's, a sharded step's ``state_shardings``): ``save`` gathers every
leaf on every rank and rank 0 writes the host layout, which is the
unsharded one, as the reference stores it; ``restore`` reads each whole
leaf and keeps this rank's block of the target spec, so a checkpoint
written on one mesh restores onto any other whose extents divide the
dims.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.interop import tree_items, tree_map

_SEP = "__"
KEEP = 3


def _safe_key(path: str) -> str:
    return _SEP.join(re.sub(r"[^\w.\-]", "_", x) for x in path.split("/"))


def _host(t: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU: the trainer updates its state in place while
    # the async writer still holds the snapshot
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _whole(state: Any, shardings: Any | None) -> list[tuple[str, Any]]:
    """(path, whole leaf) of every leaf: gathered from the ranks' blocks
    when ``shardings`` is given (a collective: every rank calls it)."""
    if shardings is None:
        return list(tree_items(state))
    from repro_torch.parallel.sharding import gather_leaf

    sh = dict(tree_items(shardings))
    return [(path, gather_leaf(t, sh[path].spec, sh[path].mesh))
            for path, t in tree_items(state)]


def _writer(shardings: Any | None) -> bool:
    """Whether this rank writes: rank 0 of a sharded state's world."""
    return shardings is None or not dist.is_initialized() \
        or dist.get_rank() == 0


def host_state(state: Any, shardings: Any | None = None
               ) -> list[tuple[str, str, np.ndarray]]:
    """(key, dtype name, host array) of every leaf, in tree order; whole
    leaves (gathered) when ``shardings`` is given."""
    return [(_safe_key(path), str(t.dtype).removeprefix("torch."), _host(t))
            for path, t in _whole(state, shardings)]


def _barrier(shardings: Any | None) -> None:
    if shardings is not None and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def save(ckpt_dir: str, state: Any, step: int, *,
         shardings: Any | None = None) -> str:
    """Synchronous atomic save. Returns the final checkpoint path. With
    ``shardings`` every rank must call it; rank 0 writes, and every rank
    returns once the checkpoint is complete."""
    leaves = host_state(state, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer(shardings):
        final = _write_host_state(ckpt_dir, leaves, step)
    _barrier(shardings)
    return final


def _write_host_state(ckpt_dir: str, leaves, step: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for key, dtype, arr in leaves:
        np.save(os.path.join(tmp, key + ".npy"), arr, allow_pickle=False)
        manifest["leaves"].append(
            {"key": key, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep=KEEP)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _load(src: str, key: str, dtype: str, like: torch.Tensor,
          device) -> torch.Tensor:
    arr = np.load(os.path.join(src, key + ".npy"))
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != "
                         f"expected {tuple(like.shape)}")
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, like: Any, *, device=None,
            shardings: Any | None = None) -> Any:
    """Restore into the structure, shapes and dtypes of ``like`` (a state
    tree, or its shapes on the meta device), on ``device`` (default: where
    ``like``'s leaves are, else ``cuda``). With ``shardings`` (``like`` the
    whole shapes), each leaf as this rank's block of its target spec."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        dtypes = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
    sh = dict(tree_items(shardings)) if shardings is not None else {}
    out = []
    for path, leaf in tree_items(like):
        key = _safe_key(path)
        if key not in dtypes:
            raise ValueError(f"checkpoint step {step} has no leaf {key}")
        dev = device if device is not None else (
            leaf.device if leaf.device.type != "meta" else resolve_device())
        t = _load(src, key, dtypes[key], leaf, dev)
        if path in sh:
            from repro_torch.parallel.sharding import shard_leaf

            t = shard_leaf(t, sh[path].spec, sh[path].mesh)
        out.append(t)
    it = iter(out)
    return tree_map(lambda _: next(it), like)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, persist on a background thread.
    With ``shardings`` every rank snapshots (the gathers are collectives)
    and rank 0 writes."""

    def __init__(self, ckpt_dir: str, shardings: Any | None = None):
        self.ckpt_dir = ckpt_dir
        self.shardings = shardings
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: Any, step: int) -> None:
        self.wait()  # one in-flight write at a time
        leaves = host_state(state, self.shardings)
        if not _writer(self.shardings):
            return

        def _run():
            try:
                _write_host_state(self.ckpt_dir, leaves, step)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
