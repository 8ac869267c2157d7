"""GPipe-style pipeline parallelism over ``torch.distributed`` (port of
``repro.parallel.pipeline``).

A ``stage`` mesh axis splits a layer stack into S contiguous stages;
microbatches stream through with the classic GPipe schedule, M + S - 1
ticks. Steady-state utilization is M / (M + S - 1), so a launcher picks M
>= 4 S. At tick t, stage s works on microbatch t - s when that is one of
the M: stage 0 pulls it from the input, every other stage takes what its
predecessor handed over at the end of tick t - 1 (``send_recv``, one
``dist.batch_isend_irecv`` a tick). The last stage collects the finished
microbatches, then broadcasts them to every stage (the reference's masked
``psum``). The collectives go through ``core.distributed``'s counted
helpers.

Each rank holds its stage's layer slice: a ``stage_params`` leaf carries
the stage on dim 0, either this rank's slice (dim 0 of 1) or all S
stages' (dim 0 of S), of which it takes its own.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import distributed as cd
from repro_torch.interop import tree_map


def pipeline_apply(
    fn: Callable,           # (stage_params, x, stage_index) -> y, y like x
    stage_params,           # leaves with a leading stage dim (1 or S)
    x: torch.Tensor,        # (M, B, ...) microbatched input, on every rank
    mesh,
    *,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``fn`` as a GPipe pipeline over mesh axis ``axis``; returns the
    (M, B, ...) output of the last stage on every rank."""
    S = mesh.axis_size(axis)
    M = x.shape[0]
    if M < S:
        raise ValueError(f"need at least {S} microbatches, got {M}")
    stage = mesh.axis_index(axis)

    def own(p):
        if p.shape[0] == S:
            return p[stage]
        if p.shape[0] == 1:
            return p[0]
        raise ValueError(f"a stage_params leaf has {p.shape[0]} stages on "
                         f"dim 0; the {axis} axis has {S}")

    params = tree_map(own, stage_params)
    outs = torch.zeros_like(x)
    buf = torch.empty_like(x[0])
    active = lambda s, t: 0 <= t - s < M
    for t in range(M + S - 1):
        out = None
        if active(stage, t):
            inp = x[t - stage] if stage == 0 else buf
            out = fn(params, inp, stage)
            if stage == S - 1:
                outs[t - stage] = out
        # hand the output to the next stage, which works on the same
        # microbatch at tick t + 1; take the predecessor's for our own
        send = out if out is not None and stage < S - 1 else None
        recv = buf if stage > 0 and active(stage, t + 1) else None
        if send is not None or recv is not None:
            cd.send_recv(send, stage + 1, recv, stage - 1, mesh, axis)
    return cd.broadcast(outs, mesh, axis, S - 1)
