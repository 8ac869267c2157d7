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


def host_state(state: Any) -> list[tuple[str, str, np.ndarray]]:
    """(key, dtype name, host array) of every leaf, in tree order."""
    return [(_safe_key(path), str(t.dtype).removeprefix("torch."), _host(t))
            for path, t in tree_items(state)]


def save(ckpt_dir: str, state: Any, step: int) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    return _write_host_state(ckpt_dir, host_state(state), step)


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


def restore(ckpt_dir: str, step: int, like: Any, *, device=None) -> Any:
    """Restore into the structure, shapes and dtypes of ``like`` (a state
    tree, or its shapes on the meta device), on ``device`` (default: where
    ``like``'s leaves are, else ``cuda``)."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        dtypes = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
    out = []
    for path, leaf in tree_items(like):
        key = _safe_key(path)
        if key not in dtypes:
            raise ValueError(f"checkpoint step {step} has no leaf {key}")
        dev = device if device is not None else (
            leaf.device if leaf.device.type != "meta" else resolve_device())
        out.append(_load(src, key, dtypes[key], leaf, dev))
    it = iter(out)
    return tree_map(lambda _: next(it), like)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, persist on a background thread."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: Any, step: int) -> None:
        self.wait()  # one in-flight write at a time
        leaves = host_state(state)

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
