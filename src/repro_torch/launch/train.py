"""End-to-end training driver with the fault-tolerance loop (port of
``repro.launch.train``).

  restore-or-init -> [step -> straggler check -> periodic async checkpoint]*
  on 'checkpoint_and_rebalance': a synchronous snapshot, then resume from
  it (``ft.elastic.resume_on_device``; the re-mesh of the reference waits
  for the port of its sharding).

Runs on the CUDA card (every GEMM of the forward and the backward on the
hand-written kernels) unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

The reference's ``--production-mesh`` is not ported.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch import configs as C
from repro_torch.core.context import use_context
from repro_torch.data.synthetic import batch_for
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.elastic import resume_on_device
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch.args import add_context_args, context_from_args
from repro_torch.models import param_count


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    add_context_args(ap, include_quant=False)
    args = ap.parse_args(argv)

    with use_context(context_from_args(args)):
        return _run(args)


def _run(args) -> dict:
    """Returns the start step and each step's loss."""
    device = resolve_device(args.device)
    cfg = C.get_config(args.arch)
    if args.smoke:
        cfg = C.smoke(cfg)
    ckpt_dir = args.ckpt_dir or os.path.join(
        "checkpoints", cfg.name.replace("/", "_"))
    resume = lambda: resume_on_device(cfg, ckpt_dir, device=device,
                                      global_batch=args.batch,
                                      seq_len=args.seq)

    art, state, start = resume()
    print(f"[train] arch={cfg.name} device={device} start_step={start} "
          f"params≈{param_count(state['params']) / 1e6:.1f}M")

    ckpt = ckpt_lib.AsyncCheckpointer(ckpt_dir)
    monitor = StragglerMonitor()
    losses = []
    for step in range(start, args.steps):
        b = batch_for(cfg, args.seq, args.batch, step)
        t0 = time.perf_counter()
        state, metrics = art.step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        verdict = monitor.record(step, dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"  step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f} ms [{verdict}]")
        if verdict == "checkpoint_and_rebalance":
            print(f"  [ft] straggler mitigation at step {step}: "
                  "sync snapshot + resume")
            ckpt.wait()
            ckpt_lib.save(ckpt_dir, state, step + 1)
            art, state, _ = resume()
        elif (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, step + 1)
    ckpt.wait()
    ckpt_lib.save(ckpt_dir, state, args.steps)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(ckpt at {ckpt_dir})")
    return {"start_step": start, "losses": losses}


if __name__ == "__main__":
    main()
