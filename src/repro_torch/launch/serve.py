"""Serving driver (port of ``repro.launch.serve``): the static-batch
server (prefill once, then greedy decode step by step; both families) and,
with ``--engine``, the continuous-batching engine over a synthetic trace
(the dense family).

Start-up follows the reference: build the execution context (loading
persisted plans), then pre-solve every GEMM signature the run issues on
the meta device (``plan_model``, or the engine's ``plan_warmup``), so
serving performs zero lazy plan solves; a warm-up that missed a signature
ends the run with ``SystemExit``. On the card each decode step (and each
engine step bucket) runs as a captured CUDA graph (``train.servestep``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --batch 4 --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --engine --num-slots 8 --kv-block-size 16 --prefill-chunk 128 \\
      --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engine \\
      --kv-block-size 4 --device cpu --metrics-json serve.json
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
from repro_torch.launch.args import (add_context_args, add_serve_engine_args,
                                     context_from_args)
from repro_torch.train.servestep import make_serve_step


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
    art = make_serve_step(cfg, device=prompts.device)
    state = models.init_decode_state(cfg, B, max_len, device=prompts.device)
    logits = art.prefill_fn(params, state, prompts)
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
        logits = art.decode_fn(params, state, tok[:, None])
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


def _run_engine(args, ctx, cfg, params, device) -> dict:
    """--engine: continuous batching over a mixed-length synthetic trace
    (with --prefix-cache a shared-header trace, with --bursty-trace bursts
    of mixed-priority traffic). Returns the engine, its metrics and the
    plan-cache counters of serving."""
    from repro_torch.serve import (ServeEngine, SimClock, bursty_trace,
                                   shared_prefix_trace, synthetic_trace)

    if args.prefix_cache and not args.kv_block_size:
        raise SystemExit("--prefix-cache needs the paged engine: pass "
                         "--kv-block-size too")
    if args.sched_policy in ("priority", "edf") and not args.kv_block_size:
        raise SystemExit(f"--sched-policy {args.sched_policy} preempts via "
                         "the paged pool: pass --kv-block-size too")
    gen = args.max_new_tokens or args.gen
    plen = args.prompt_len
    stop = (args.eos_id,) if args.eos_id is not None else ()
    n_requests = max(args.batch, 2 * args.num_slots)
    prompt_pad = plen
    if args.bursty_trace:
        # interactive class: short prompts and answers, a deadline a few
        # bursts out; background class: long prompts and answers
        header = plen if args.prefix_cache else 0
        classes = [
            dict(priority=2, prompt_lens=(max(1, plen // 2), plen),
                 max_new_tokens=(max(1, gen // 4), max(1, gen // 2)),
                 deadline_slack_s=10 * args.burst_gap_s, weight=1.0),
            dict(priority=0, prompt_lens=(2 * plen,),
                 max_new_tokens=(gen,), deadline_slack_s=None, weight=1.0),
        ]
        trace = bursty_trace(
            n_requests, vocab_size=cfg.vocab_size,
            burst_size=args.burst_size, burst_gap_s=args.burst_gap_s,
            classes=classes, header_len=header, stop_ids=stop, seed=0)
        prompt_pad = header + 2 * plen
        max_len = prompt_pad + gen + 1
    elif args.prefix_cache:
        # every request repeats a plen-token header + a short unique tail
        tails = [1, 3, 5]
        trace = shared_prefix_trace(
            n_requests, vocab_size=cfg.vocab_size, header_len=plen,
            tail_lens=tails,
            max_new_tokens=[gen, max(1, gen // 2), max(1, gen // 4)],
            stop_ids=stop, seed=0)
        max_len = plen + max(tails) + gen + 1
    else:
        trace = synthetic_trace(
            n_requests, vocab_size=cfg.vocab_size,
            prompt_lens=[plen, max(1, plen // 2), max(1, (3 * plen) // 4)],
            max_new_tokens=[gen, max(1, gen // 2), max(1, gen // 4)],
            stop_ids=stop, seed=0)
        max_len = plen + gen + 1
    engine = ServeEngine(
        cfg, params, num_slots=args.num_slots, max_len=max_len,
        prompt_pad=prompt_pad, kv_block_size=args.kv_block_size or None,
        num_kv_blocks=args.num_kv_blocks, prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache,
        prefix_cache_blocks=args.prefix_cache_blocks,
        temperature=args.temperature, top_p=args.top_p,
        sched_policy=args.sched_policy, ttft_target_ms=args.ttft_target_ms,
        max_prefill_chunks=args.max_prefill_chunks,
        clock=SimClock(args.sim_clock) if args.sim_clock else None)
    if not args.no_warmup:
        t0 = time.perf_counter()
        warm = engine.plan_warmup()
        _report_warmup(ctx, warm, time.perf_counter() - t0, "engine warm-up")

    m = engine.run(trace)
    ptag = (f" paged(block={engine.kv_block_size},"
            f"pool={engine.num_kv_blocks})" if engine.paged else "")
    # rates are None when their denominator never moved (a SimClock run
    # finishing inside one resolution step)
    tps = (f"{m.tokens_per_sec:.1f} tok/s" if m.tokens_per_sec is not None
           else f"{m.tokens_per_tick:.2f} tok/tick")
    occ = (f"{m.mean_occupancy:.2f}" if m.mean_occupancy is not None
           else "n/a")
    print(f"[engine]{ptag} arch={cfg.name} hw={ctx.hw.name} device={device} "
          f"slots={args.num_slots}: {len(trace)} requests, "
          f"{m.generated_tokens} tokens in {m.wall_s:.2f}s ({tps} incl. "
          f"first calls), mean occupancy {occ}/{args.num_slots}, "
          f"{m.ticks} ticks, steps {dict(sorted(engine.dispatches.items()))}")
    if engine.paged:
        bp = m.block_pool
        print(f"[block-pool] peak {bp['peak_in_use']}/{bp['num_blocks'] - 1} "
              f"blocks ({bp['peak_utilization']:.2f} util), memory ratio "
              f"{bp['memory_ratio']:.2f}x contiguous, "
              f"{m.deferred_admissions} deferred admissions, "
              f"peak internal frag {bp['peak_fragmentation_tokens']} tokens")
    if m.prefix_cache:
        px = m.prefix_cache
        print(f"[prefix-cache] hit {px['hit_tokens']}/{px['lookup_tokens']} "
              f"prompt tokens ({px['hit_rate']:.2f} hit rate), "
              f"{px['inserted_blocks']} blocks cached, "
              f"{px['reclaimed_blocks']} reclaimed")
    if m.policy != "fifo" or m.preemptions or m.deadline_missed:
        print(f"[sched] policy={m.policy} preemptions={m.preemptions} "
              f"resumes={m.resumes} deadline_missed={m.deadline_missed} "
              f"deferred={m.deferred_admissions}")
    pc = m.plan_cache
    print(f"[plan-cache] serving: hits={pc['hits']} misses={pc['misses']} "
          f"lazy_solves={pc['lazy_solves']} "
          f"steady_state={pc['steady_state']}")
    first = engine.finished[0]
    print(f"first finished: id={first.request.request_id} "
          f"reason={first.finish_reason} tokens={first.tokens[:12]} ...")
    if args.metrics_json:
        m.to_json(args.metrics_json)
        print(f"[engine] metrics written to {args.metrics_json}")
    if not args.no_warmup and (pc["lazy_solves"] or pc["misses"]):
        raise SystemExit(
            f"plan warm-up incomplete: {pc['misses']} unseen signatures, "
            f"{pc['lazy_solves']} lazy solves during serving")
    return {"engine": engine, "metrics": m, "trace": trace, "context": ctx,
            "tokens": m.generated_tokens, "seconds": m.wall_s,
            "lazy_solves": pc["lazy_solves"], "misses": pc["misses"]}


def main(argv: list[str] | None = None) -> dict:
    """Run the server; returns what it printed as numbers (tokens, seconds,
    plan-cache counters; with --engine also the engine, its metrics, the
    trace and the execution context) for callers that drive it
    in-process."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the plan pre-solve (plans solve lazily)")
    add_context_args(ap)
    add_serve_engine_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ctx = context_from_args(args)
    with use_context(ctx):
        cfg = C.get_config(args.arch)
        if args.smoke:
            cfg = C.smoke(cfg)
        params = models.init(cfg, seed=0, device=device)
        if args.engine:
            return _run_engine(args, ctx, cfg, params, device)
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
