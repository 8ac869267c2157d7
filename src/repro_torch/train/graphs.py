"""Step functions captured as CUDA graphs: the port's counterpart of
``jax.jit`` with ``donate_argnums`` (``repro/train/servestep.py:57,177,287``).

The reference compiles each serving step once per shape bucket and runs it
on donated state buffers. Here :class:`CapturedStep` wraps a raw step
``fn(params, state, *inputs) -> logits`` and keeps one CUDA graph per
bucket (the shapes and dtypes of ``inputs``):

* the first call of a bucket copies its inputs into static device buffers,
  runs the step eagerly on the helper's side stream (that call's result;
  it is also where the kernels set their shared-memory attributes, look up
  ``cuTensorMapEncodeTiled`` in libcuda and size their split-K tickets),
  then captures the same call into a graph on that stream;
* every later call copies its inputs into the buffers, replays the graph
  and returns the graph's static logits buffer, valid until the next call.

The state tensors are the graph's own buffers, written in place by every
replay (the steps update their lengths in place): a call with another
state or other parameters than the captured ones raises, since the graph
holds their addresses (and the TMA descriptors encoded from them). On a
CPU device a call runs the raw step and nothing else.

A replay launches no Python, so the kernel wrappers' ``launches`` counters
do not see it. The launches a graph holds are counted at capture (and the
wrappers' counters put back, since capture launches nothing), and each
replay adds them to :data:`replayed`; :func:`launches` is the sum of both.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import interop
from repro_torch.kernels import decode_matvec, matmul, wkv

_KERNELS = {"matmul": matmul, "gemv": decode_matvec, "wkv": wkv}

# kernel launches made by graph replays, by kernel
replayed: dict[str, int] = dict.fromkeys(_KERNELS, 0)


def eager_launches() -> dict[str, int]:
    """Launches the kernel wrappers made themselves (eager calls)."""
    return {k: mod.launches for k, mod in _KERNELS.items()}


def launches() -> dict[str, int]:
    """Every kernel launch: eager calls plus graph replays."""
    return {k: n + replayed[k] for k, n in eager_launches().items()}


def reset_launches() -> None:
    for k, mod in _KERNELS.items():
        mod.launches = 0
        replayed[k] = 0


@contextlib.contextmanager
def counted():
    """Yields a dict that, on exit, holds the launches the wrappers counted
    inside the block; their counters are put back to what they were (a
    capture records launches without making them)."""
    before = eager_launches()
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        for k, mod in _KERNELS.items():
            made[k] = mod.launches - before[k]
            mod.launches = before[k]


def as_tensor(x) -> torch.Tensor:
    """An input as a tensor: ints and numpy arrays become int64 on the
    CPU; tensors pass as they are."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


def _addresses(tree) -> tuple[int, ...]:
    return tuple(t.data_ptr() for _, t in interop.tree_items(tree))


@dataclasses.dataclass
class _Graph:
    graph: Any                     # torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]     # static input buffers
    out: torch.Tensor              # static logits buffer
    launches: dict[str, int]       # kernel launches one replay makes
    replays: int = 0

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            replayed[k] += n
        return self.out


class CapturedStep:
    """One CUDA graph per input bucket of ``fn(params, state, *inputs)``;
    on a CPU device, ``fn`` itself."""

    def __init__(self, fn: Callable, device: torch.device | str):
        self.fn = fn
        self.device = torch.device(device)
        self.graphs: dict[tuple, _Graph] = {}
        self._stream = None
        self._pool = None
        self._bound: tuple | None = None   # (params, state) addresses

    def __call__(self, params, state, *inputs) -> torch.Tensor:
        ins = [as_tensor(x) for x in inputs]
        if self.device.type != "cuda":
            return self.fn(params, state, *(t.to(self.device) for t in ins))
        bound = (_addresses(params), _addresses(state))
        if self._bound is None:
            self._bound = bound
        elif bound != self._bound:
            raise ValueError("a captured step runs on the parameters and "
                             "state it was captured with (the graph holds "
                             "their addresses)")
        key = tuple((tuple(t.shape), t.dtype) for t in ins)
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, params, state, ins)
        for buf, t in zip(g.inputs, ins):
            buf.copy_(t.pin_memory() if t.device.type == "cpu" else t,
                      non_blocking=True)
        return g.replay()

    def _capture(self, key, params, state, ins) -> torch.Tensor:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            # one pool for the buckets: their intermediates are scratch
            # (the graphs run one at a time, on one stream), and each
            # graph's logits buffer stays referenced here
            self._pool = torch.cuda.graph_pool_handle()
        bufs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in ins]
        for buf, t in zip(bufs, ins):
            buf.copy_(t)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self.fn(params, state, *bufs)
        main.wait_stream(self._stream)
        out.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        with counted() as made:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                static_out = self.fn(params, state, *bufs)
        self.graphs[key] = _Graph(graph, bufs, static_out, made)
        return out
