"""Static-batch server (port of ``repro.launch.serve`` without
``--engine``): prefill once, then greedy decode step by step.

Start-up follows the reference: build the execution context (loading
persisted plans), then ``plan_model`` pre-solves every GEMM signature the
model issues (prefill + decode) on the meta device, so serving performs
zero lazy plan solves; a warm-up that missed a signature ends the run with
``SystemExit``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --batch 4 --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import models
from repro_torch.core.context import use_context
from repro_torch.core.gemm import plan_model
from repro_torch.device import resolve_device
from repro_torch.launch.args import add_context_args, context_from_args


def serve_batch(cfg, params, prompts: torch.Tensor, *, gen_len: int,
                max_len: int, eos_id: int | None = None,
                pad_id: int = 0) -> torch.Tensor:
    """prompts: (B, P) int64 on the model's device. Returns (B, gen_len).

    With ``eos_id``, generation stops per sequence at the first stop token:
    the stop token is kept, the tail is ``pad_id``, and a finished row
    keeps feeding ``pad_id``. The batch decodes until every row finishes or
    ``gen_len``.
    """
    B = prompts.shape[0]
    state = models.init_decode_state(cfg, B, max_len, device=prompts.device)
    logits, state = models.prefill(params, {"tokens": prompts}, cfg, state)
    out = []
    finished = torch.zeros((B,), dtype=torch.bool, device=prompts.device)
    tok = logits[:, : cfg.vocab_size].argmax(-1)
    for _ in range(gen_len):
        if eos_id is not None:
            tok = torch.where(finished, pad_id, tok)
        out.append(tok)
        if eos_id is not None:
            finished = finished | (tok == eos_id)
            if bool(finished.all()):
                break
        logits, state = models.decode_step(params, tok[:, None], cfg, state)
        tok = logits[:, : cfg.vocab_size].argmax(-1)
    gen = torch.stack(out, dim=1)
    if gen.shape[1] < gen_len:  # every row hit EOS early: pad the tail
        gen = torch.nn.functional.pad(gen, (0, gen_len - gen.shape[1]),
                                      value=pad_id)
    return gen


def _report_warmup(ctx, warm: dict, seconds: float, label: str) -> None:
    """Persist the warmed plans and print one warm-up summary line."""
    saved = ctx.plan_cache.save()
    print(f"[plan-cache] {label} {seconds:.2f}s: "
          f"{warm['signatures']} signatures, {warm['solved']} solved, "
          f"{warm['from_cache']} from cache (hw={ctx.hw.name}"
          + (f", persisted to {saved}" if saved else "") + ")")


def main(argv: list[str] | None = None) -> dict:
    """Run the server; returns what it printed as numbers (tokens, seconds,
    plan-cache counters) for callers that drive it in-process."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=None, metavar="ID",
                    help="stop id: sequences end early on this token")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the plan pre-solve (plans solve lazily)")
    add_context_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ctx = context_from_args(args)
    with use_context(ctx):
        cfg = C.get_config(args.arch)
        if args.smoke:
            cfg = C.smoke(cfg)
        params = models.init(cfg, seed=0, device=device)
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(args.batch, args.prompt_len))).to(device)

        max_len = args.prompt_len + args.gen + 1
        if not args.no_warmup:
            t0 = time.perf_counter()
            warm = plan_model(cfg, batch=args.batch,
                              prompt_len=args.prompt_len, max_len=max_len,
                              params=params)
            _report_warmup(ctx, warm, time.perf_counter() - t0, "warm-up")
        warm_stats = ctx.plan_cache.stats.snapshot()

        t0 = time.perf_counter()
        out = serve_batch(cfg, params, prompts, gen_len=args.gen,
                          max_len=max_len, eos_id=args.eos_id)
        out = out.cpu()  # waits for the device
        dt = time.perf_counter() - t0
        toks = args.batch * args.gen
        print(f"[serve] arch={cfg.name} hw={ctx.hw.name} device={device} "
              f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s "
              f"incl. any first-call kernel build)")
        print("first row:", out[0].numpy()[:12], "...")

        st = ctx.plan_cache.stats
        lazy = st.lazy_solves - warm_stats.lazy_solves
        missed = st.misses - warm_stats.misses
        print(f"[plan-cache] serving: hits={st.hits - warm_stats.hits} "
              f"misses={missed} lazy_solves={lazy} ({st})")
        if not args.no_warmup and (lazy or missed):
            raise SystemExit(
                f"plan warm-up incomplete: {missed} unseen signatures, "
                f"{lazy} lazy solves during serving")
    return {"tokens": toks, "seconds": dt, "lazy_solves": lazy,
            "misses": missed, "generated": out}


if __name__ == "__main__":
    main()
