"""End-to-end training driver with the fault-tolerance loop (port of
``repro.launch.train``).

  restore-or-init -> [step -> straggler check -> periodic async checkpoint]*
  on 'checkpoint_and_rebalance': a synchronous snapshot, then resume from
  it (``ft.elastic.resume_on_device``, or ``resume_on_mesh``: the re-mesh).

Runs on the CUDA card (every GEMM of the forward and the backward on the
hand-written kernels) unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

Sharded (``train.trainstep``'s mesh step over ``torch.distributed``):
``--mesh DATAxMODEL`` lays the world's ranks out as a (data, model) mesh;
``--production-mesh`` takes the reference's 16 x 16 (``--multi-pod``: 2 x
16 x 16) and raises unless the world has 256 (512) ranks. One process a
rank, under torchrun:

  torchrun --nproc-per-node 1 -m repro_torch.launch.train --mesh 1x1 ...
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh 4x2 \\
      --smoke --device cpu ...
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 1x2 \\
      --backend gloo --n-layers 4 --ckpt-every 0 ...

With a mesh, rank 0 prints and writes the checkpoints (whole leaves), and
each step's collective bytes are counted. The step is tensor-parallel over
'model' (``train.trainstep``). ``--backend gloo`` puts several ranks on
one card (each collective staged through host memory); nccl is the
default there. ``--n-layers`` cuts the config's depth (its width stays);
``--record-out PATH`` has rank 0 write each step's loss, gradient norm,
collective bytes and host seconds, its kernel launches and the final
parameters, whole, to PATH (``torch.save``; the launches include the
WKV backward kernel's, ``wkv_bwd``). ``--ckpt-every 0`` writes no
checkpoint at all (a run at full width, whose state is tens of GB).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from repro_torch import configs as C
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.data.synthetic import batch_for
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.elastic import resume_on_device, resume_on_mesh
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch.args import add_context_args, context_from_args
from repro_torch.launch.mesh import BACKENDS, init_mesh
from repro_torch.models import param_count
from repro_torch.train import graphs


def parse_mesh(text: str) -> tuple[int, int]:
    """'DATAxMODEL' -> (data, model)."""
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DATAxMODEL, got {text!r}") from None
    return data, model


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between checkpoints; 0: no checkpoint")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="shard the step over a (data, model) mesh of the "
                         "world's ranks (default: one device)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16 x 16 mesh (256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: 2 x 16 x 16 (512 ranks)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="the mesh's collectives (default: nccl on the "
                         "card, gloo on the CPU; gloo on the card stages "
                         "them through host memory)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to N layers (full width)")
    ap.add_argument("--record-out", default=None, metavar="PATH",
                    help="rank 0 writes the run's losses, gradient norms, "
                         "collective bytes, step seconds and final "
                         "parameters (whole) to PATH")
    add_context_args(ap, include_quant=False)
    args = ap.parse_args(argv)

    with use_context(context_from_args(args)):
        return _run(args)


def _mesh(args, device):
    kw = dict(device=device, backend=args.backend)
    if args.production_mesh:
        if args.multi_pod:
            return init_mesh((2, 16, 16), ("pod", "data", "model"), **kw)
        return init_mesh((16, 16), ("data", "model"), **kw)
    if args.multi_pod:
        raise ValueError("--multi-pod goes with --production-mesh")
    if args.mesh is None:
        if args.backend is not None:
            raise ValueError("--backend goes with --mesh")
        return None
    return init_mesh(parse_mesh(args.mesh), ("data", "model"), **kw)


def _slowest(dt: float, mesh) -> float:
    """The step's seconds on its slowest rank: every rank's straggler
    monitor then reaches the same verdict, and the checkpoint it may call
    for is a collective (a control message, outside the step's count)."""
    if mesh is None or mesh.size == 1:
        return dt
    import torch
    import torch.distributed as dist

    t = torch.tensor([dt], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _run(args) -> dict:
    """Returns the start step, each step's loss and host seconds, and with
    a mesh each step's collective bytes."""
    device = resolve_device(args.device)
    cfg = C.get_config(args.arch)
    if args.smoke:
        cfg = C.smoke(cfg)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers).validate()
    mesh = _mesh(args, device)
    ckpt_dir = args.ckpt_dir or os.path.join(
        "checkpoints", cfg.name.replace("/", "_"))
    kw = dict(global_batch=args.batch, seq_len=args.seq)
    if mesh is None:
        resume = lambda: resume_on_device(cfg, ckpt_dir, device=device, **kw)
    else:
        resume = lambda: resume_on_mesh(cfg, mesh, ckpt_dir, **kw)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    art, state, start = resume()
    say(f"[train] arch={cfg.name} device={device} "
        f"mesh={'none' if mesh is None else mesh.describe()} "
        f"start_step={start} params≈{param_count(state['params']) / 1e6:.1f}M"
        f"{'' if mesh is None else ' (this rank)'}")

    ckpt = ckpt_lib.AsyncCheckpointer(ckpt_dir, art.state_shardings) \
        if args.ckpt_every > 0 else None
    monitor = StragglerMonitor()
    losses, seconds, coll, gnorms = [], [], [], []
    before = graphs.train_launches()
    for step in range(start, args.steps):
        b = batch_for(cfg, args.seq, args.batch, step)
        t0 = time.perf_counter()
        with CollectiveCounter() as counter:
            state, metrics = art.step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the step
        dt = _slowest(time.perf_counter() - t0, mesh)
        verdict = monitor.record(step, dt)
        losses.append(loss)
        seconds.append(dt)
        coll.append(counter.by_kind())
        gnorms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"  step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"{dt*1e3:7.1f} ms [{verdict}]"
                + ("" if mesh is None else
                   f" collective bytes {counter.total}"))
        if ckpt is None:
            continue
        if verdict == "checkpoint_and_rebalance":
            say(f"  [ft] straggler mitigation at step {step}: "
                "sync snapshot + resume")
            ckpt.wait()
            ckpt_lib.save(ckpt_dir, state, step + 1,
                          shardings=art.state_shardings)
            art, state, _ = resume()
        elif (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, step + 1)
    if ckpt is not None:
        ckpt.wait()
        ckpt_lib.save(ckpt_dir, state, args.steps,
                      shardings=art.state_shardings)
    if losses:
        say(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            + (f"(ckpt at {ckpt_dir})" if ckpt is not None else
               "(no checkpoint)"))
    if args.record_out:
        _record(args.record_out, art, state, mesh, lead,
                {"losses": losses, "grad_norms": gnorms, "step_s": seconds,
                 "collective_bytes": coll, "start_step": start,
                 "launches": {k: n - before[k] for k, n in
                              graphs.train_launches().items()}})
    return {"start_step": start, "losses": losses, "step_s": seconds,
            "collective_bytes": coll, "microbatches": art.microbatches,
            "grad_norms": gnorms}


def _record(path: str, art, state, mesh, lead: bool, rec: dict) -> None:
    """--record-out: the parameters gathered whole (every rank takes part,
    outside the steps' count) and written with ``rec`` by rank 0."""
    import torch

    from repro_torch.interop import tree_items
    from repro_torch.parallel import sharding as shd

    spec_of = {} if mesh is None else {
        p: s.spec for p, s in tree_items(art.state_shardings["params"])}
    params = {}
    for p, t in tree_items(state["params"]):
        t = t.detach()
        if mesh is not None:
            t = shd.gather_leaf(t, spec_of[p], mesh)
        if lead:
            params[p] = t.cpu()
        del t
    if lead:
        torch.save({**rec, "params": params}, path)


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
