"""Serving driver (port of ``repro.launch.serve``): the static-batch
server (prefill once, then greedy decode step by step; the dense, moe,
rwkv, hybrid, encdec and vlm families; encdec's frame embeddings and vlm's
image embeddings are drawn from the prompts' generator, as the
reference's launcher draws them) and, with
``--engine``, the continuous-batching engine over a synthetic trace (the
KV-cache families, dense and moe).

Start-up follows the reference: build the execution context (loading
persisted plans), make the weights from seed 0 (with ``--quantize int8``
quantized once at load, ``quant.prequant.quantize_params``), then pre-solve
every GEMM signature the run issues on the meta device (``plan_model``, or
the engine's ``plan_warmup``), so serving performs zero lazy plan solves; a
warm-up that missed a signature ends the run with ``SystemExit``. On the
card each decode step (and each engine step bucket) runs as a captured
CUDA graph (``train.servestep``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --batch 4 --prompt-len 128 --gen 16 [--quantize int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --engine --num-slots 8 --kv-block-size 16 --prefill-chunk 128 \\
      --prompt-len 128 --gen 16 [--quantize int8 --kv-quantize int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      [--engine --kv-block-size 16] [--quantize int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      [--quantize int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      [--quantize int8]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-11b [--quantize int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  torchrun --nproc-per-node 8 -m repro_torch.launch.serve --mesh 4x2 \\
      --smoke --device cpu
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1x2 \\
      --backend gloo --batch 4 --prompt-len 128 --gen 16
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --engine \\
      --kv-block-size 4 --mesh 1x2 --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engine \\
      --kv-block-size 4 --device cpu --metrics-json serve.json
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engine \\
      --kv-block-size 4 --device cpu --quantize int8 --kv-quantize int8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engine \\
      --kv-block-size 4 --device cpu --spec-draft-config qwen1.5-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engine \\
      --kv-block-size 4 --device cpu --plan-cache '' --trace-out t.json \\
      --metrics-json m.json --metrics-interval-ticks 2 --measure-plans \\
      --rebalance-drifted

With ``--trace-out`` the engine runs under the flight recorder: the Chrome
trace is written there, the metrics JSON gains the ``timing`` and
``attribution`` sections, and with ``--metrics-interval-ticks`` the
registry's Prometheus text goes next to the metrics JSON (``.prom``).
``--measure-plans`` refines the warm-up's plans by timing the fat GEMM
kernel at each plan and its neighbouring tiles before the first call (so
the CUDA graphs are captured with the refined plans);
``--rebalance-drifted`` re-solves the plans the balance auditor flags as
drifted after a traced run.

With ``--mesh DATAxMODEL`` the static server (every family, float or
``--quantize int8``) runs over a (data, model) mesh of the world's ranks,
one process a rank under torchrun: the ranks make the whole model from
seed 0 one at a time (the others wait at a barrier), each quantizing the
whole weights (int8) and keeping its blocks
(``parallel.sharding.param_specs``; a row-parallel block keeps the whole
``w_scale``) and freeing the whole before the next begins, so the card
holds one whole model at a time; each serves
its rows over 'data' (encdec's frames and vlm's image embeddings, drawn
whole as on one device, cut to the same rows), tensor-parallel over
'model' (attention, the MLPs, RWKV-6's time-mix and channel-mix,
Mamba-2's SSM heads), the MoE experts over 'data' (expert parallelism);
every rank ends with every row's tokens and rank 0 prints. ``--backend
gloo`` puts several ranks on one card (each collective staged through
host memory); nccl is the default on the card. With ``--engine --mesh``
the engine (the KV-cache families, dense and moe; paged, contiguous or
speculative) runs over the mesh the same way: the ranks make
the model (and the draft) in turn, the engine takes their blocks
(``ServeEngine(mesh=, blocks=True)``), and every rank runs the whole
schedule on the same logits and rank 0's clock.
``--n-layers`` cuts the config's depth (its width stays), the draft's
too.
``--record-out PREFIX`` writes what the run measured to
``PREFIX.rank<r>.pt``: for the static run its tokens, the prefill's and
each step's logits and top-2 margins, collective bytes, seconds,
launches, plan-cache counters, the load's and serving's peak memory; for
the engine each request's tokens, the admission sequence, the aggregate
counters and the speculation section, the dispatches, each step's
collective bytes and host ms by phase tag, the clock's bytes, launches,
plan-cache counters, this rank's state bytes, the peaks, every committed
token's top-2 margin and each request's first-token logits.

With ``--spec-draft-config`` the engine decodes speculatively: the draft
(built from seed 0 like the target, shrunk with it under ``--smoke``, and
quantized to int8 at load unless ``--spec-draft-quantize none``) proposes
``--spec-k`` tokens a lane a round and the target verifies them.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import models
from repro_torch.core.context import use_context
from repro_torch.core.gemm import plan_model
from repro_torch.device import resolve_device
from repro_torch.interop import is_quantized
from repro_torch.launch.args import (add_context_args, add_serve_engine_args,
                                     context_from_args)
from repro_torch.launch.mesh import BACKENDS, make_local_mesh
from repro_torch.launch.train import parse_mesh
from repro_torch.models import param_count
from repro_torch.quant.prequant import quantize_params
from repro_torch.train import graphs
from repro_torch.train.servestep import make_serve_step, prefill_input_shapes


def serve_batch(cfg, params, prompts: torch.Tensor, *, gen_len: int,
                max_len: int, extras: dict | None = None,
                eos_id: int | None = None, pad_id: int = 0, mesh=None,
                record: dict | None = None) -> torch.Tensor:
    """prompts: (B, P) int64 on the model's device; ``extras`` the
    family's other prefill inputs (encdec: ``frames``, vlm:
    ``image_embeds``). Returns (B, gen_len).

    With ``eos_id``, generation stops per sequence at the first stop token:
    the stop token is kept, the tail is ``pad_id``, and a finished row
    keeps feeding ``pad_id``. The batch decodes until every row finishes or
    ``gen_len``.

    Over a ``mesh`` (every family, float or int8; ``train.servestep``)
    ``params`` are this rank's blocks (``make_serve_step(...).
    shard_params``) and every rank passes the whole batch and ``extras``:
    each runs its rows over the DP axes (``ServeArtifacts.rows``),
    tensor-parallel over 'model', and returns the whole (B, gen_len) (the
    tokens gathered over the DP axes).

    ``record`` (a dict), if given, receives what the run measured: the
    logits of the prefill and of each decode step (this rank's rows, f32
    on the host), each step's top-2 margin of the logits that chose its
    token, the collective bytes of the prefill and of each decode step
    (in all and by kind), the host seconds of each (synchronized), and
    the final decode state (``state``: over a mesh this rank's blocks).
    """
    from repro_torch.core.distributed import CollectiveCounter

    B = prompts.shape[0]
    device = prompts.device
    quantized = is_quantized(params)
    art = make_serve_step(cfg, device=device, mesh=mesh, quantized=quantized,
                          batch=B, max_len=max_len)
    state = art.init_state(B, max_len)
    inputs = art.rows({"tokens": prompts, **(extras or {})})
    rec = record if record is not None else {}
    rec.update(prefill_bytes=0, decode_bytes=[], decode_s=[], margin=[],
               logits=[], decode_by_kind=[])

    def timed(fn, *args):
        t0 = time.perf_counter()
        with CollectiveCounter() as counter:
            out = fn(*args)
        if record is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["by_kind"] = counter.by_kind()
        return out, counter.total, time.perf_counter() - t0

    def pick(logits):
        top = logits[:, : cfg.vocab_size]
        if record is not None:
            two = top.topk(2, dim=-1).values
            rec["margin"].append((two[:, 0] - two[:, 1]).cpu())
            rec["logits"].append(logits.float().cpu())
        return top.argmax(-1)

    logits, rec["prefill_bytes"], rec["prefill_s"] = timed(
        art.prefill_fn, params, state, inputs)
    rec["prefill_by_kind"] = rec.pop("by_kind")
    rows = logits.shape[0]
    out = []
    finished = torch.zeros((rows,), dtype=torch.bool, device=device)
    tok = pick(logits)
    for _ in range(gen_len):
        if eos_id is not None:
            tok = torch.where(finished, pad_id, tok)
        out.append(tok)
        if eos_id is not None:
            finished = finished | (tok == eos_id)
            if _all_finished(finished, mesh):
                break
        logits, nbytes, secs = timed(art.decode_fn, params, state,
                                     tok[:, None])
        rec["decode_bytes"].append(nbytes)
        rec["decode_by_kind"].append(rec.pop("by_kind"))
        rec["decode_s"].append(secs)
        tok = pick(logits)
    rec["state"] = state
    gen = torch.stack(out, dim=1)
    if gen.shape[1] < gen_len:  # every row hit EOS early: pad the tail
        gen = torch.nn.functional.pad(gen, (0, gen_len - gen.shape[1]),
                                      value=pad_id)
    if mesh is not None and rows != B:
        from repro_torch.parallel import sharding as shd

        gen = shd.gather_leaf(gen.contiguous(), shd.batch_specs(
            {"t": prompts}, mesh)["t"], mesh)
    return gen


def _all_finished(finished: torch.Tensor, mesh) -> bool:
    """Whether every row finished, on every DP rank of the mesh (a control
    message, outside the collective count): the ranks stop together."""
    done = torch.tensor([int(bool(finished.all()))], dtype=torch.int64,
                        device=finished.device)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        if mesh.backend == "gloo" and done.device.type == "cuda":
            done = done.cpu()
        dist.all_reduce(done, op=dist.ReduceOp.MIN)
    return bool(done.item())


def _report_warmup(ctx, warm: dict, seconds: float, label: str) -> None:
    """Persist the warmed plans and print one warm-up summary line."""
    saved = ctx.plan_cache.save()
    print(f"[plan-cache] {label} {seconds:.2f}s: "
          f"{warm['signatures']} signatures, {warm['solved']} solved, "
          f"{warm['from_cache']} from cache (hw={ctx.hw.name}"
          + (f", persisted to {saved}" if saved else "") + ")")


def _measure_plans(ctx, device, measure_factory=None) -> dict:
    """--measure-plans: refine the warm-up's plans with CUDA-event timings
    of the fat GEMM kernel (the plain version's host time on the CPU;
    ``core.autotune``) and persist the refined set. ``measure_factory``
    replaces the timing (``refine_cached_plans``'s). Returns the
    refinement counts and, by plan key, each refined plan's (old, new)."""
    from repro_torch.core.autotune import refine_cached_plans

    cache = ctx.plan_cache
    old = dict(cache.entries)
    t0 = time.perf_counter()
    stats = refine_cached_plans(cache, device=device,
                                measure_factory=measure_factory)
    saved = cache.save()
    changed = {k: (old[k], p) for k, p in cache.entries.items()
               if k in old and p != old[k]}
    print(f"[plan-cache] measured refinement {time.perf_counter()-t0:.2f}s: "
          f"{stats['measured']} measurements, {stats['refined']} plans "
          f"refined, {stats['kept']} kept"
          + (f", persisted to {saved}" if saved else ""))
    for k, (a, b) in sorted(changed.items()):
        print(f"[plan-cache] refined {k[1]}x{k[2]}x{k[3]} {k[4]} {k[6]}: "
              f"({a.bm}, {a.bk}, {a.bn}) -> ({b.bm}, {b.bk}, {b.bn})")
    return {"stats": stats, "changed": changed}


def _report_attrib(ctx, engine, m, *, rebalance: bool) -> dict | None:
    """Print the balance auditor's verdict and, with --rebalance-drifted,
    feed the drifted warm plans through a model re-solve + hill-climb.
    Returns the rebalance counts (None when nothing was rebalanced).

    The metrics JSON keeps the audited (pre-rebalance) attribution: the
    re-solve restores the cache for the next run, it does not rewrite the
    evidence that triggered it.
    """
    a = m.attribution
    if not a:
        return None
    recon = a.get("reconciliation_error")
    print(f"[attrib] {a['signatures']} signatures: attributed "
          f"{a['attributed_device_s']:.3f}s of {a['traced_device_s']:.3f}s "
          f"traced GEMM-phase device time (recon err "
          + (f"{recon:.3f}" if recon is not None else "n/a")
          + "), bound shares "
          + ", ".join(f"{k}={v:.2f}" if v is not None else f"{k}=n/a"
                      for k, v in sorted(a["bound_share"].items()))
          + f", drifted={a['drifted_count']}")
    rows = a.get("by_device_s") or []
    if rows:
        top = rows[0]
        print(f"[attrib] top signature {top['key']}: "
              f"{top['device_s']:.3f}s ({top['share']:.2f} share, "
              f"{top['calls']} calls, bound={top['bound']})")
    for k in a.get("drifted", []):
        row = next((r for r in rows if r["key"] == k), None)
        sug = ""
        if row is not None and row.get("suggested_bm") is not None:
            sug = (f" -> suggest bm={row['suggested_bm']} "
                   f"bk={row['suggested_bk']} bn={row['suggested_bn']} "
                   f"(x{row['suggested_gain']:.2f} modeled)")
        print(f"[attrib] drifted: {k}{sug}")
    if not rebalance:
        return None
    keys = engine.attrib.drifted_keys()
    if not keys:
        print("[attrib] rebalance: no drifted warm plans, nothing to do")
        return None
    from repro_torch.core.autotune import model_measure_fn, refine_cached_plans

    t0 = time.perf_counter()
    stats = refine_cached_plans(
        ctx.plan_cache, keys=keys, resolve=True,
        measure_factory=lambda M, K, N, **kw: model_measure_fn(
            M, K, N, hw=ctx.hw, **kw))
    saved = ctx.plan_cache.save()
    print(f"[attrib] rebalanced {len(keys)} drifted plans in "
          f"{time.perf_counter()-t0:.2f}s: {stats['refined']} refined, "
          f"{stats['kept']} kept"
          + (f", persisted to {saved}" if saved else ""))
    return stats


def _run_engine(args, ctx, cfg, box: list, device, measure_factory=None,
                mesh=None) -> dict:
    """--engine: continuous batching over a mixed-length synthetic trace
    (with --prefix-cache a shared-header trace, with --bursty-trace bursts
    of mixed-priority traffic). ``box`` holds the params (over a ``mesh``
    this rank's blocks; taken out, so that the engine holds the only
    reference). Returns the engine, its metrics and the plan-cache
    counters of serving."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import (ServeEngine, SimClock, bursty_trace,
                                   shared_prefix_trace, synthetic_trace)

    if args.prefix_cache and not args.kv_block_size:
        raise SystemExit("--prefix-cache needs the paged engine: pass "
                         "--kv-block-size too")
    if args.sched_policy in ("priority", "edf") and not args.kv_block_size:
        raise SystemExit(f"--sched-policy {args.sched_policy} preempts via "
                         "the paged pool: pass --kv-block-size too")
    if args.kv_quantize != "none" and not args.kv_block_size:
        raise SystemExit("--kv-quantize stores per-block scales alongside "
                         "the block pool: pass --kv-block-size too")
    spec_kwargs = {}
    if args.spec_draft_config:
        if not args.kv_block_size:
            raise SystemExit("--spec-draft-config needs the paged engine: "
                             "pass --kv-block-size too")
        if args.temperature > 0:
            raise SystemExit("speculative decoding verifies greedy argmax "
                             "chains: --temperature must be 0")
        dcfg = C.get_config(args.spec_draft_config)
        if args.smoke:
            dcfg = C.smoke(dcfg)
        if args.n_layers is not None:
            dcfg = dataclasses.replace(dcfg, n_layers=args.n_layers).validate()
        # the target's --quantize recipe, once at load
        dquant = "int8" if args.spec_draft_quantize == "int8" else None
        dparams, _ = _load(dcfg, device, mesh, dquant == "int8")
        spec_kwargs = dict(spec_draft_cfg=dcfg, spec_draft_params=dparams,
                           spec_k=args.spec_k, spec_draft_quant=dquant)
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
    if args.rebalance_drifted and not args.trace_out:
        raise SystemExit("--rebalance-drifted needs the balance auditor's "
                         "traced attribution: pass --trace-out too")
    tracer = (Tracer(ring_events=args.trace_ring_events)
              if args.trace_out else None)
    lead = mesh is None or mesh.rank == 0
    print_ = print if lead else (lambda *a, **k: None)
    engine = ServeEngine(
        cfg, box.pop(), mesh=mesh, blocks=mesh is not None,
        num_slots=args.num_slots,
        max_len=max_len,
        prompt_pad=prompt_pad, kv_block_size=args.kv_block_size or None,
        num_kv_blocks=args.num_kv_blocks, kv_quantize=args.kv_quantize,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache,
        prefix_cache_blocks=args.prefix_cache_blocks,
        temperature=args.temperature, top_p=args.top_p,
        sched_policy=args.sched_policy, ttft_target_ms=args.ttft_target_ms,
        max_prefill_chunks=args.max_prefill_chunks,
        clock=SimClock(args.sim_clock) if args.sim_clock else None,
        tracer=tracer, metrics_interval_ticks=args.metrics_interval_ticks,
        attrib_tol=args.attrib_tol, **spec_kwargs)
    spec_kwargs = dparams = None  # the engine keeps (its blocks of) them
    # the load's peak (over a mesh: the whole init and the blocks at once)
    init_peak = _peak_gib(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if mesh is not None:
        print_(f"[mesh] {mesh.describe()}: {mesh.size} ranks; this rank's "
               f"state {engine.pool_bytes} bytes (the load's transient peak "
               f"{init_peak:.2f} GiB); the steps run "
               + ("eager" if any(n > 1 for n in mesh.shape) else "captured"))
    if args.record_out:
        engine.token_log = []
    measured = None
    if not args.no_warmup:
        t0 = time.perf_counter()
        warm = engine.plan_warmup()
        if lead:
            _report_warmup(ctx, warm, time.perf_counter() - t0,
                           "engine warm-up")
        if args.measure_plans:
            # before the first call: each bucket's graph is captured at
            # its first call, with the refined plans
            measured = _measure_plans(ctx, device, measure_factory)

    before = graphs.launches()
    m = engine.run(trace)
    launched = {k: n - before[k] for k, n in graphs.launches().items()}
    qtag = f" quant={ctx.quant_mode}" if ctx.quant_mode else ""
    ptag = (f" paged(block={engine.kv_block_size},"
            f"pool={engine.num_kv_blocks})" if engine.paged else "")
    # rates are None when their denominator never moved (a SimClock run
    # finishing inside one resolution step)
    tps = (f"{m.tokens_per_sec:.1f} tok/s" if m.tokens_per_sec is not None
           else f"{m.tokens_per_tick:.2f} tok/tick")
    occ = (f"{m.mean_occupancy:.2f}" if m.mean_occupancy is not None
           else "n/a")
    print_(f"[engine]{ptag} arch={cfg.name}{qtag} hw={ctx.hw.name} "
           f"device={device} "
           f"slots={args.num_slots}: {len(trace)} requests, "
           f"{m.generated_tokens} tokens in {m.wall_s:.2f}s ({tps} incl. "
           f"first calls), mean occupancy {occ}/{args.num_slots}, "
           f"{m.ticks} ticks, steps {dict(sorted(engine.dispatches.items()))}")
    if engine.paged:
        bp = m.block_pool
        print_(f"[block-pool] peak {bp['peak_in_use']}/{bp['num_blocks'] - 1} "
               f"blocks ({bp['peak_utilization']:.2f} util), memory ratio "
               f"{bp['memory_ratio']:.2f}x contiguous, "
               f"{m.deferred_admissions} deferred admissions, "
               f"peak internal frag {bp['peak_fragmentation_tokens']} tokens")
        kv = m.kv_cache
        if kv["quantized"]:
            print_(f"[kv-quant] {kv['kv_dtype']} pool: {kv['pool_bytes']} "
                   f"bytes vs {kv['bf16_pool_bytes']} bf16 "
                   f"({kv['bytes_ratio']:.3f}x; {kv['bytes_per_block']} bytes "
                   f"a block), scale max k {kv['scale_k_max']:.4g} v "
                   f"{kv['scale_v_max']:.4g}")
    pc = m.plan_cache
    if m.speculation["enabled"]:
        sp = m.speculation
        print_(f"[spec] draft={sp['draft_arch']}"
               + (f"({sp['draft_quant']})" if sp["draft_quant"] else "")
               + f" k={sp['spec_k']}: {sp['rounds']} rounds, accepted "
               f"{sp['accepted_tokens']}/{sp['proposed_tokens']} proposals "
               f"({sp['acceptance_rate']:.2f}), "
               f"{sp['mean_committed_per_round']:.2f} tokens/round, "
               f"draft {sp['draft_s']:.2f}s / verify {sp['verify_s']:.2f}s, "
               f"lazy_solves={pc['lazy_solves']}")
    if m.prefix_cache:
        px = m.prefix_cache
        print_(f"[prefix-cache] hit {px['hit_tokens']}/{px['lookup_tokens']} "
               f"prompt tokens ({px['hit_rate']:.2f} hit rate), "
               f"{px['inserted_blocks']} blocks cached, "
               f"{px['reclaimed_blocks']} reclaimed")
    if m.policy != "fifo" or m.preemptions or m.deadline_missed:
        print_(f"[sched] policy={m.policy} preemptions={m.preemptions} "
               f"resumes={m.resumes} deadline_missed={m.deadline_missed} "
               f"deferred={m.deferred_admissions}")
    print_(f"[plan-cache] serving: hits={pc['hits']} misses={pc['misses']} "
           f"lazy_solves={pc['lazy_solves']} "
           f"steady_state={pc['steady_state']}")
    first = engine.finished[0]
    print_(f"first finished: id={first.request.request_id} "
           f"reason={first.finish_reason} tokens={first.tokens[:12]} ...")
    rebalanced = None
    if tracer is not None:
        obj = tracer.save(args.trace_out)
        t = m.timing
        print_(f"[trace] {len(obj['traceEvents'])} events "
               f"({t.get('events_dropped', 0)} dropped) -> {args.trace_out}; "
               f"host {t.get('host_s', 0.0):.3f}s / device "
               f"{t.get('device_s', 0.0):.3f}s across "
               f"{len(t.get('phases', {}))} phases")
        rebalanced = _report_attrib(ctx, engine, m,
                                    rebalance=args.rebalance_drifted)
    if args.metrics_json:
        m.to_json(args.metrics_json)
        print_(f"[engine] metrics written to {args.metrics_json}")
        if args.metrics_interval_ticks:
            prom_path = args.metrics_json + ".prom"
            with open(prom_path, "w") as f:
                f.write(engine.registry.to_prometheus_text())
            print_(f"[registry] {len(engine.registry.snapshots)} snapshots, "
                   f"exposition written to {prom_path}")
    if mesh is not None:
        ms = {k: 1e3 * statistics.median(v) for k, v in engine.step_s.items()}
        print_(f"[mesh] collective bytes a rank by step "
               f"{ {k: sorted(set(v)) for k, v in engine.step_bytes.items()} }"
               f", clock {engine.clock_bytes.total}; median ms by step "
               f"{ {k: round(v, 2) for k, v in sorted(ms.items())} }; peak "
               f"{_peak_gib(device):.2f} GiB")
    if args.record_out:
        ids = {r.request_id: i for i, r in enumerate(trace)}
        rank = 0 if mesh is None else mesh.rank
        torch.save({
            "tokens": {ids[st.request.request_id]: list(st.tokens)
                       for st in engine.finished},
            "admissions": [(ids[st.request.request_id], st.slot,
                            st.admitted_tick, st.first_token_tick,
                            st.finished_tick, st.finish_reason,
                            st.preemptions, st.cached_tokens)
                           for st in engine.finished],
            "engine": m.to_dict()["engine"],
            "aggregate": m.to_dict()["aggregate"],
            "speculation": m.speculation,
            "dispatches": dict(engine.dispatches),
            "step_bytes": engine.step_bytes,
            "step_kinds": engine.step_kinds,
            "clock_bytes": engine.clock_bytes.by_kind(),
            "step_ms": {k: [1e3 * x for x in v]
                        for k, v in engine.step_s.items()},
            "launches": launched, "lazy_solves": pc["lazy_solves"],
            "misses": pc["misses"], "pool_bytes": engine.pool_bytes,
            "init_peak_gib": init_peak, "peak_gib": _peak_gib(device),
            "token_log": [(ids[r], *rest) for r, *rest in engine.token_log],
            "first_logits": {ids[r]: torch.from_numpy(v) for r, v in
                             engine.first_logits.items()},
            "mesh": None if mesh is None else mesh.describe(),
            "rank": rank}, f"{args.record_out}.rank{rank}.pt")
    if not args.no_warmup and (pc["lazy_solves"] or pc["misses"]):
        raise SystemExit(
            f"plan warm-up incomplete: {pc['misses']} unseen signatures, "
            f"{pc['lazy_solves']} lazy solves during serving")
    return {"engine": engine, "metrics": m, "trace": trace, "context": ctx,
            "tokens": m.generated_tokens, "seconds": m.wall_s,
            "lazy_solves": pc["lazy_solves"], "misses": pc["misses"],
            "measured": measured, "rebalanced": rebalanced}


def main(argv: list[str] | None = None, *, measure_factory=None) -> dict:
    """Run the server; returns what it printed as numbers (tokens, seconds,
    plan-cache counters; with --engine also the engine, its metrics, the
    trace, the execution context, and what --measure-plans and
    --rebalance-drifted changed) for callers that drive it in-process.
    ``measure_factory``: the timing --measure-plans refines with, in place
    of ``core.autotune.wallclock_measure_fn``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the plan pre-solve (plans solve lazily)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="the static server or the engine over a (data, "
                         "model) mesh of the world's ranks (default: one "
                         "device)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="the mesh's collectives (default: nccl on the "
                         "card, gloo on the CPU; gloo on the card stages "
                         "them through host memory)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to N layers (full width)")
    ap.add_argument("--record-out", default=None, metavar="PREFIX",
                    help="write what the run measured to PREFIX.rank<r>.pt")
    add_context_args(ap)
    add_serve_engine_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ctx = context_from_args(args)
    mesh = None
    if args.mesh is not None:
        mesh = make_local_mesh(*parse_mesh(args.mesh), device=device,
                               backend=args.backend)
    elif args.backend is not None:
        raise SystemExit("--backend goes with --mesh")
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    with use_context(ctx):
        cfg = C.get_config(args.arch)
        if args.smoke:
            cfg = C.smoke(cfg)
        if args.n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.n_layers).validate()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        # over a mesh this rank's blocks, the ranks loading one at a time
        params, quantize_s = _load(cfg, device, mesh,
                                   ctx.quant_mode == "int8")
        if quantize_s is not None:
            say(f"[quant] int8 weights quantized at load in "
                f"{quantize_s:.2f}s")
        if args.engine:
            box = [params]
            del params
            res = _run_engine(args, ctx, cfg, box, device, measure_factory,
                              mesh)
            res["quantize_s"] = quantize_s
            return res
        # the load's peak (over a mesh: the whole init and the blocks at
        # once), then serving's own
        init_peak = _peak_gib(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if mesh is not None:
            eager = any(n > 1 for n in mesh.shape)
            say(f"[mesh] {mesh.describe()}: {mesh.size} ranks; this rank "
                f"keeps {param_count(params) / 1e6:.1f}M parameters "
                f"(the load's transient peak {init_peak:.2f} GiB); the "
                f"decode step runs {'eager' if eager else 'captured'}")
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(args.batch, args.prompt_len))).to(device)
        # the family's other inputs (encdec's frame embeddings, vlm's
        # image embeddings: the stubs of the audio frontend and the vision
        # tower): standard normals from the same generator
        extras = {
            k: torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(device)
            for k, (shape, _) in prefill_input_shapes(
                cfg, args.batch, args.prompt_len).items() if k != "tokens"}

        max_len = args.prompt_len + args.gen + 1
        if not args.no_warmup:
            t0 = time.perf_counter()
            warm = plan_model(cfg, batch=args.batch,
                              prompt_len=args.prompt_len, max_len=max_len,
                              params=params, extras=extras, mesh=mesh)
            if lead:
                _report_warmup(ctx, warm, time.perf_counter() - t0,
                               "warm-up")
        warm_stats = ctx.plan_cache.stats.snapshot()

        record = {} if args.record_out or mesh is not None else None
        before = graphs.launches()
        t0 = time.perf_counter()
        out = serve_batch(cfg, params, prompts, gen_len=args.gen,
                          max_len=max_len, extras=extras,
                          eos_id=args.eos_id, mesh=mesh, record=record)
        out = out.cpu()  # waits for the device
        dt = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in graphs.launches().items()}
        toks = args.batch * args.gen
        qtag = f" quant={ctx.quant_mode}" if ctx.quant_mode else ""
        say(f"[serve] arch={cfg.name}{qtag} hw={ctx.hw.name} device={device} "
            f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s "
            f"incl. any first-call kernel build)")
        say("first row:", out[0].numpy()[:12], "...")

        st = ctx.plan_cache.stats
        lazy = st.lazy_solves - warm_stats.lazy_solves
        missed = st.misses - warm_stats.misses
        say(f"[plan-cache] serving: hits={st.hits - warm_stats.hits} "
            f"misses={missed} lazy_solves={lazy} ({st})")
        if mesh is not None:
            say(f"[mesh] collective bytes a rank: prefill "
                f"{record['prefill_bytes']}, a decode step "
                f"{sorted(set(record['decode_bytes']))}; peak "
                f"{_peak_gib(device):.2f} GiB")
        if record is not None:
            record.pop("state")
        if args.record_out:
            record.update(
                tokens=out, launches=launched, lazy_solves=lazy,
                misses=missed, init_peak_gib=init_peak,
                peak_gib=_peak_gib(device), seconds=dt,
                margin=torch.stack(record["margin"], 1),
                mesh=None if mesh is None else mesh.describe(),
                rank=0 if mesh is None else mesh.rank)
            torch.save(record, f"{args.record_out}.rank{record['rank']}.pt")
        if not args.no_warmup and (lazy or missed):
            raise SystemExit(
                f"plan warm-up incomplete: {missed} unseen signatures, "
                f"{lazy} lazy solves during serving")
    return {"tokens": toks, "seconds": dt, "lazy_solves": lazy,
            "misses": missed, "generated": out, "quantize_s": quantize_s,
            "launches": launched, "record": record}


def _load(cfg, device, mesh, quantize: bool):
    """The weights from seed 0 (``quantize``: quantized once at load, so
    that decode streams int8 weights and the dequantize rides the GEMM
    epilogue; the f32 projections are freed with the float tree) and the
    quantization's seconds (None without it). Over a ``mesh`` this rank's
    blocks (``servestep.param_blocks``): the ranks build the whole model
    one at a time, each keeping its blocks and freeing the whole before a
    barrier lets the next begin, so the card holds one whole model at a
    time."""
    from repro_torch.train.servestep import param_blocks

    def build():
        params = models.init(cfg, seed=0, device=device)
        seconds = None
        if quantize:
            t0 = time.perf_counter()
            params = quantize_params(params)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
        if mesh is not None:
            params = param_blocks(cfg, params, mesh, quantized=quantize)
        return params, seconds

    if mesh is None or mesh.size == 1:
        return build()
    import torch.distributed as dist

    out = None
    for rank in range(mesh.size):
        if rank == mesh.rank:
            out = build()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _peak_gib(device) -> float:
    """The device's peak allocated memory so far, GiB (0 on the CPU)."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**30


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
