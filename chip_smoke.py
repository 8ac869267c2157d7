#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port (``src/repro_torch``) runs on one H100.

  python3 chip_smoke.py            # phases 1-5 and 7; needs one CUDA card
  python3 chip_smoke.py --profile  # and phase 6 and the traced engine run

Three paths, each at a model's full width and depth with random weights:
the static server on qwen1.5-4b (dense; the fat GEMM and GEMV kernels) and
on rwkv6-3b (RWKV-6; the same two and the WKV kernel), and the paged
continuous-batching engine on qwen1.5-4b. Every decode step and engine
step runs as a captured CUDA graph. Phases, in order; any failure ends the
run with a non-zero exit:

1. environment: card name and power limit, torch and CUDA versions,
   compute capability (9, 0) required; TF32 off for the plain versions;
2. build: the three CUDA sources under ``src/repro_torch/kernels/csrc``
   with nvcc, in parallel;
3. kernels: each kernel at its path's shapes (batch 4, prompt 128) against
   its plain PyTorch version on the same inputs, with its time, its bound,
   the plain version's time and one library call's time where there is
   one (3a: the GEMMs, each with the route the wrapper picks and its bound
   at that route's rate, the GEMV's with its K splits, then a sweep of
   untimed GEMV cases over every dtype pair, layout, 1..128 rows and both
   routes; 3b: WKV through both wrappers, each case with the slice width,
   blocks and load route its wrapper picks, the path cases at both slice
   widths, and the layout copies the path no longer makes);
4. path (4a qwen1.5-4b, 40 layers; 4b rwkv6-3b, 32 layers):
   ``repro_torch.launch.serve --arch ARCH --batch 4 --prompt-len 128
   --gen 16`` with the plan warm-up; zero lazy solves, and launch counts
   (eager calls plus graph replays) equal to what the dispatch rule
   implies, counted from 0 for each path; then the decode step run eagerly
   and as a CUDA-graph replay from one state: step ms and tok/s of each,
   and the replay's logits and state equal to the eager step's bit for
   bit;
5. kernel path against plain path (5a qwen, 5b rwkv): the config cut to 2
   layers, prefill plus 4 decode steps on the card and on the CPU from the
   same weights, logits held to a stated tolerance (rwkv's 128-token
   prefill takes the WKV kernel);
6. with ``--profile`` only: each phase 4 path again with everything warm,
   prefill and decode steps timed with CUDA events, then once more under
   ``torch.profiler``: device time by kernel, the fat GEMM's by route, the
   GEMV's by kernel name (one kernel launch per call, or the run fails),
   WKV's with the kernels beside each launch (no copy, or the run fails),
   and the device's idle share; for the eager decode step and for its
   CUDA-graph replay, the breakdown from the replayed run;
7. engine path: ``repro_torch.launch.serve --arch qwen1.5-4b --engine
   --num-slots 8 --kv-block-size 16 --prefill-chunk 128 --prompt-len 128
   --gen 16`` (16 requests of prompt 128, 64 and 96): every request
   finishes with in-vocab ids, zero lazy solves and misses, launches equal
   to the dispatch rule for the ticks and chunks that ran; a warm rerun
   with the decode tick timed (and, with ``--profile``, a traced one:
   idle share); one decode tick and one prefill chunk of each bucket,
   replayed, equal to the same step run eagerly, bit for bit.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports neither jax nor repro.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,        # f32 on the CUDA cores (data sheet)
            "bfloat16": 989e12,      # bf16 tensor cores, dense (data sheet)
            "int8": 1979e12}         # int8 tensor cores, dense (data sheet)

BATCH, PROMPT, GEN = 4, 128, 16
# launches the dispatch rule (core/gemm.py: GEMV when M <= 128, K >= 256,
# N >= 128 and no epilogue) implies for each path, 16 decode steps:
# * qwen1.5-4b (qkv bias, SwiGLU), 40 layers: prefill 7 fat GEMMs a layer
#   + the last-token unembed on the GEMV; decode q, k, v (bias) and gate
#   (silu) fat, wo, w_in, w_out + unembed GEMV;
# * rwkv6-3b, 32 layers: prefill 11 fat GEMMs a layer (lora_a, w_lora_a,
#   w_lora_b, r, k, v, g, o, cmix wk + relu, wv, wr) + the unembed GEMV and
#   one WKV launch a layer (T = 128 takes the chunk branch); decode 3 fat
#   (w_lora_a N = 32, w_lora_b K = 32, cmix wk + relu) and 8 GEMVs a layer
#   + the unembed, and no WKV launch (T = 1 is the token scan)
PATHS = {
    "qwen1.5-4b": {"vocab": 151936, "want": {
        "matmul": 7 * 40 + GEN * 4 * 40, "gemv": 1 + GEN * (3 * 40 + 1),
        "wkv": 0}},
    "rwkv6-3b": {"vocab": 65536, "want": {
        "matmul": 11 * 32 + GEN * 3 * 32, "gemv": 1 + GEN * (8 * 32 + 1),
        "wkv": 32}},
}
PATH_TOL = 5e-2  # kernel vs plain logits, bf16 activations (see phase 5)
# phase 7: the paged engine at qwen1.5-4b's width and depth, 8 lanes
ENGINE_ARGS = ["--arch", "qwen1.5-4b", "--engine", "--num-slots", "8",
               "--kv-block-size", "16", "--prefill-chunk", "128",
               "--prompt-len", str(PROMPT), "--gen", str(GEN),
               "--plan-cache", ""]
# launches of one engine step (40 layers): a decode tick at 8 rows and a
# prefill chunk at 32-128 rows both run q, k, v (bias) and gate (silu) on
# the fat GEMM and wo, w_in, w_out on the GEMV (M <= 128, no epilogue),
# plus the one unembed GEMV (8 rows, or the chunk's last token)
ENGINE_STEP = {"matmul": 4 * 40, "gemv": 3 * 40 + 1, "wkv": 0}


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


def environment(torch) -> str:
    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} capability {cap}")
    if cap != (9, 0):
        raise SystemExit(f"needs a Hopper card (sm_90), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from repro_torch.kernels import build

    phase("2 build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"built {sorted(logs) or 'nothing (already built)'} in "
          f"{time.perf_counter() - t0:.1f}s (nvcc, in parallel)")
    for name, log in logs.items():
        regs, spills, fn = [], [], "?"
        for ln in log.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("for", 1)[1].strip()
            elif "registers" in ln:
                regs.append(int(ln.split("Used ")[1].split()[0]))
            elif "spill" in ln and not ("0 bytes spill stores" in ln
                                        and "0 bytes spill loads" in ln):
                spills.append(f"{fn}: {ln.strip()}")
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers, {len(spills)} with spills")
        for sp in spills:
            print(f"    spill {sp}")
        with open(os.path.join(build.build_dir(), f"{name}.ptxas.log"),
                  "w") as f:
            f.write(log)


# ------------------------------------------------------------ phase 3
def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` single calls timed with CUDA events, each after
    reading a 256 MiB buffer so that no operand starts in the 50 MB L2 (the
    main path streams 15.8 GB of weights a step: they are always cold). A
    read leaves no dirty lines whose write-back the timed call would pay.
    The read also keeps the card busy (~0.1 ms) while the host enqueues the
    timed call, so the events time the device, not the host's launch
    overhead (which phase 6 shows end to end)."""
    flush = torch.ones(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@dataclasses.dataclass
class Case:
    name: str
    kernel: str          # "matmul" | "gemv"
    M: int
    K: int
    N: int
    a_dtype: str = "bfloat16"
    b_dtype: str = "float32"
    out_dtype: str = "bfloat16"
    layout: str = "row"
    bias: bool = False
    activation: str | None = None
    scale: bool = False


CASES = [
    Case("prefill q/k/v + bias", "matmul", 512, 2560, 2560, bias=True),
    Case("prefill gate + silu", "matmul", 512, 2560, 6912,
         activation="silu"),
    Case("prefill w_out", "matmul", 512, 6912, 2560),
    Case("decode q/k/v + bias", "matmul", 4, 2560, 2560, bias=True),
    Case("decode gate + silu", "matmul", 4, 2560, 6912, activation="silu"),
    Case("col layout + bias", "matmul", 512, 2560, 2560, layout="col",
         bias=True),
    # the W8A8 path's layout: int8 weights (N, K)
    Case("int8 requant -> int8", "matmul", 512, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int8", layout="col", bias=True,
         scale=True),
    Case("ragged + gelu", "matmul", 333, 1000, 777, bias=True,
         activation="gelu"),
    # rwkv6-3b's decay LoRA pair at prefill
    Case("rwkv w_lora_a", "matmul", 512, 2560, 32),
    Case("rwkv w_lora_b", "matmul", 512, 32, 2560),
    Case("prefill bf16 x bf16", "matmul", 512, 2560, 2560,
         b_dtype="bfloat16", bias=True),
    # an f32 output shows the three-term split of an f32 B is exact
    Case("prefill f32 out", "matmul", 512, 2560, 2560, out_dtype="float32",
         bias=True),
    Case("int8 decode col requant", "matmul", 4, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int8", layout="col", bias=True,
         scale=True),
    Case("int8 row -> int32", "matmul", 512, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int32"),
    Case("decode wo", "gemv", 4, 2560, 2560),
    Case("decode w_in", "gemv", 4, 2560, 6912),
    Case("decode w_out", "gemv", 4, 6912, 2560),
    Case("unembed f32 out", "gemv", 4, 2560, 151936, out_dtype="float32"),
    Case("col layout", "gemv", 4, 2560, 2560, layout="col"),
    Case("ragged", "gemv", 3, 1000, 777),
    # rwkv6-3b's decode GEMVs that the qwen shapes above do not cover
    Case("rwkv lora_a", "gemv", 4, 2560, 160),
    Case("rwkv cmix wv", "gemv", 4, 8960, 2560),
    Case("rwkv unembed f32 out", "gemv", 4, 2560, 65536, out_dtype="float32"),
    # more rows: one row group past 8, and a paged-engine-sized batch (W
    # must cross HBM once, not once per 8 rows)
    Case("decode wo B=9", "gemv", 9, 2560, 2560),
    Case("decode wo B=64", "gemv", 64, 2560, 2560),
    Case("decode wo B=128", "gemv", 128, 2560, 2560),
    # the engine's rows (phase 7): decode ticks at 8 lanes, prefill chunks
    # of 32, 64 and 128 tokens
    Case("engine q/k/v + bias M=8", "matmul", 8, 2560, 2560, bias=True),
    Case("engine gate + silu M=8", "matmul", 8, 2560, 6912,
         activation="silu"),
    Case("chunk q/k/v + bias M=32", "matmul", 32, 2560, 2560, bias=True),
    Case("chunk gate + silu M=32", "matmul", 32, 2560, 6912,
         activation="silu"),
    Case("chunk q/k/v + bias M=64", "matmul", 64, 2560, 2560, bias=True),
    Case("chunk gate + silu M=128", "matmul", 128, 2560, 6912,
         activation="silu"),
    Case("engine wo B=8", "gemv", 8, 2560, 2560),
    Case("engine w_in B=8", "gemv", 8, 2560, 6912),
    Case("engine w_out B=8", "gemv", 8, 6912, 2560),
    Case("engine unembed B=8 f32 out", "gemv", 8, 2560, 151936,
         out_dtype="float32"),
    Case("chunk w_in B=32", "gemv", 32, 2560, 6912),
    Case("chunk w_in B=64", "gemv", 64, 2560, 6912),
    Case("chunk w_in B=128", "gemv", 128, 2560, 6912),
    Case("chunk w_out B=128", "gemv", 128, 6912, 2560),
]
# GEMV cases held to their plain version but not timed: every dtype pair,
# both layouts, 1..128 rows, ragged K and N, both routes
GEMV_SWEEP = [
    Case(f"sweep {a}x{b}->{o} {lay} B={M}", "gemv", M, K, N, a_dtype=a,
         b_dtype=b, out_dtype=o, layout=lay)
    for M, K, N in [(1, 2560, 2560), (4, 1000, 776), (33, 2560, 2560),
                    (64, 992, 136), (128, 2560, 2560), (128, 992, 136)]
    for a, b, o in [("bfloat16", "float32", "bfloat16"),
                    ("bfloat16", "float32", "float32"),
                    ("bfloat16", "bfloat16", "float32"),
                    ("float32", "float32", "float32"),
                    ("float32", "bfloat16", "bfloat16"),
                    ("int8", "int8", "int32"), ("int8", "int8", "int8")]
    for lay in ("row", "col")
] + [Case("sweep unaligned col B=64", "gemv", 64, 1001, 300, layout="col"),
     Case("sweep unaligned int8 row B=9", "gemv", 9, 333, 1001,
          a_dtype="int8", b_dtype="int8", out_dtype="int16")]
# the case that stands for each kernel in the JSON record
RECORD_CASE = {"matmul": "prefill gate + silu", "gemv": "unembed f32 out"}


def _inputs(torch, c: Case, gen):
    dt = lambda name: getattr(torch, name)

    def rnd(shape, name, scale=1.0):
        if name == "int8":
            return torch.randint(-100, 100, shape, generator=gen,
                                 device="cuda", dtype=torch.int8)
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.to(dt(name))

    a = rnd((c.M, c.K), c.a_dtype)
    b_shape = (c.N, c.K) if c.layout == "col" else (c.K, c.N)
    b = rnd(b_shape, c.b_dtype, c.K ** -0.5)
    bias = rnd((c.N,), "float32") if c.bias else None
    scale = (torch.rand((c.N,), generator=gen, device="cuda") * 2e-4
             if c.scale else None)
    return a, b, bias, scale


def _library_call(torch, c: Case, a, b, bias):
    """One PyTorch call computing the same product (a yardstick only, never
    used by the port). int8: ``torch._int_mm`` (cuBLASLt int8 x int8 ->
    int32), the product only: no PyTorch call fuses the requant, bias and
    saturating cast, so that epilogue is left out of the yardstick."""
    bt = b.t() if c.layout == "col" else b
    if c.a_dtype == "int8":
        # cuBLASLt's int8 product takes more than 16 rows only
        return (lambda: torch._int_mm(a, bt)) if c.M > 16 else None
    if bias is not None:
        return lambda: torch.addmm(bias, a.float(), bt.float())
    return lambda: torch.mm(a.float(), bt.float())


def _rate(c: Case, route: str) -> float:
    """The rate of the route a case takes: an f32 B on the tensor cores is
    three bf16 passes, a bf16 B one; int8 tensor cores; the CUDA-core routes
    (split-K, CUDA core, the GEMV) at the f32 rate."""
    if route == "tensor_core":
        return PEAK_OPS["bfloat16"] / (3 if c.b_dtype == "float32" else 1)
    if route == "tensor_core_int8":
        return PEAK_OPS["int8"]
    return PEAK_OPS["float32"]


def _bound(c: Case, torch, route: str) -> tuple[float, str]:
    size = lambda name: getattr(torch, name).itemsize
    moved = (c.M * c.K * size(c.a_dtype) + c.K * c.N * size(c.b_dtype)
             + c.M * c.N * size(c.out_dtype)
             + 4 * c.N * (int(c.bias) + int(c.scale)))
    ops = 2 * c.M * c.K * c.N
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / _rate(c, route)
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def check_kernels(torch) -> dict[str, dict]:
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_for
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import decode_matvec as tmv
    from repro_torch.kernels import matmul as tmm
    from repro_torch.kernels import ops, ref

    phase("3a GEMM kernels against their plain versions (on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    props = torch.cuda.get_device_properties(0)
    with use_context(hw="h100", plan_cache=PlanCache()):
        for timed, c in [(True, c) for c in CASES] + [
                (False, c) for c in GEMV_SWEEP]:
            a, b, bias, scale = _inputs(torch, c, gen)
            out_dtype = getattr(torch, c.out_dtype)
            plan = plan_for(c.M, c.K, c.N, in_dtype=a.dtype,
                            out_dtype=out_dtype, b_layout=c.layout)
            split, mma = "", False
            if c.kernel == "matmul":
                route = tmm.route(c.M, a.dtype, b.dtype, c.layout,
                                  tmm.tma_aligned(a, b))
                kern = lambda: ops.balanced_matmul(
                    a, b, bias, plan=plan, out_dtype=out_dtype,
                    b_layout=c.layout, activation=c.activation,
                    out_scale=scale)
                plain = lambda: ref.matmul_ref(
                    a, b, out_dtype=out_dtype, b_layout=c.layout, bias=bias,
                    activation=c.activation, out_scale=scale)
            else:
                route = tmv.route(b, c.layout)
                bk = min(plan.bk, -(-c.K // tmm.BK_STEP) * tmm.BK_STEP)
                lp = tmv.launch_plan(c.M, c.K, c.N, bk, plan.bn, a.dtype,
                                     b.dtype, c.layout, route,
                                     props.multi_processor_count,
                                     props.shared_memory_per_block_optin)
                mma = lp.mt > 0
                groups = (1 if route == tmv.TMA
                          else -(-c.M // tmm.rows_per_group(c.M)))
                split = (f" splits={lp.splits}x{lp.k_per_split} blocks="
                         f"{-(-c.N // plan.bn) * groups * lp.splits}"
                         + (f" mma_tiles={lp.mt}" if lp.mt else ""))
                kern = lambda: ops.decode_matvec(
                    a, b, bk=plan.bk, bn=plan.bn, out_dtype=out_dtype,
                    w_layout=c.layout)
                plain = lambda: ref.gemv_ref(a, b, out_dtype=out_dtype,
                                             w_layout=c.layout)
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = (got.double() - want.double()).abs().max().item()
            peak = want.double().abs().max().item()
            # Same inputs, same f32 (i32) accumulation, another summation
            # order: an f32 result may differ by ~1e-6 relative; a bf16
            # result may round the other way, one bf16 ulp = 2**-7 of the
            # largest value; an int8 requant result may flip one rint tie;
            # the GEMV's integer outputs (i32 sums, saturated) are exact.
            if c.out_dtype == "bfloat16":
                tol = 2.0 ** -7 * max(1.0, peak)
            elif c.out_dtype == "float32":
                tol = 1e-5 * max(1.0, peak)
            else:
                tol = 0.0 if c.kernel == "gemv" else 1.0
            if not timed:
                print(f"{c.kernel:6s} {c.name:34s} MKN={c.M}x{c.K}x{c.N} "
                      f"route={route} plan={[plan.bk, plan.bn]}{split} "
                      f"err={err:.3g} tol={tol:.3g}", flush=True)
                if not err <= tol:
                    raise SystemExit(f"{c.kernel} case {c.name!r} disagrees "
                                     f"with its plain version: {err} > {tol}")
                del a, b, bias, scale, got, want
                continue
            lib = _library_call(torch, c, a, b, bias)
            if route == "tensor_core" and c.b_dtype == "float32":
                # a yardstick of one bf16 pass only: another product (B
                # rounded to bf16), which the port never computes
                b16 = b.bfloat16()
                bt16 = b16.t() if c.layout == "col" else b16
                print(f"       {c.name:22s} bf16_library_ms="
                      f"{time_ms(torch, lambda: torch.mm(a, bt16)):.4f} "
                      "(torch.mm(a, b.bfloat16()), one bf16 pass)",
                      flush=True)
                del b16, bt16
            rec = {
                "case": c.name, "kernel": c.kernel, "route": route,
                "shape": [c.M, c.K, c.N], "layout": c.layout,
                "dtypes": [c.a_dtype, c.b_dtype, c.out_dtype],
                "plan": [plan.bm, plan.bk, plan.bn],
                "max_abs_err": err, "tol": tol,
                "ms": time_ms(torch, kern),
                "plain_ms": time_ms(torch, plain),
                "library_ms": None if lib is None else time_ms(torch, lib),
            }
            # the GEMV's tensor-core consumers run the matmul route's three
            # bf16 passes of an f32 W
            rec["bound_ms"], rec["bound_by"] = _bound(
                c, torch, "tensor_core" if mma else route)
            results.append(rec)
            print(f"{c.kernel:6s} {c.name:22s} MKN={c.M}x{c.K}x{c.N} "
                  f"{c.layout} route={route} plan={rec['plan']}{split} "
                  f"err={err:.3g} tol={tol:.3g} ms={rec['ms']:.4f} "
                  f"plain_ms={rec['plain_ms']:.4f} library_ms="
                  + ("null" if lib is None else f"{rec['library_ms']:.4f}")
                  + f" bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})",
                  flush=True)
            if not err <= tol:
                raise SystemExit(f"{c.kernel} case {c.name!r} disagrees with "
                                 f"its plain version: {err} > {tol}")
            del a, b, bias, scale, got, want
    return {r["kernel"]: r for r in results
            if r["case"] == RECORD_CASE[r["kernel"]]}


# ------------------------------------------------------------ phase 3b
@dataclasses.dataclass
class WkvCase:
    name: str
    B: int
    H: int
    T: int
    N: int
    w0: tuple = (-6.0, 1.0)  # log(-log w) drawn uniform in this range
    tol: float = 2e-4
    heads: bool = False      # wkv_heads on (B, T, H, N) bf16 r, k, v
    offset: int = 0          # r, k, v start this many elements into a buffer


# the rwkv6-3b path's shape (batch 4 x 40 heads of 64, prompt 128), the
# reference test's shapes (tests/test_kernels_wkv.py) and its adversarial
# decay range; tolerances are that test's: rtol = atol = 2e-4, and 1e-3
# for the adversarial range (decays down to e^-3.3 a step re-centred over
# a chunk: the factored exponentials lose a few more bits). The last two
# cases are what time_mix launches: bf16 (B, T, H, N) views of the
# projections and the f32 log decay, read in place; the smoke config's
# heads of 16 one element off a 16-byte boundary take the scalar loads.
WKV_CASES = [
    WkvCase("path B4 H40 T128 N64", 4, 40, 128, 64),
    WkvCase("reference (1, 2, 96, 128)", 1, 2, 96, 128),
    WkvCase("reference (1, 1, 32, 64)", 1, 1, 32, 64),
    WkvCase("adversarial decay (1, 2, 64, 32)", 1, 2, 64, 32,
            w0=(-8.0, 1.2), tol=1e-3),
    WkvCase("path heads bf16 B4 T128 H40 N64", 4, 40, 128, 64, heads=True),
    WkvCase("unaligned heads bf16 (2, 4, 64, 16)", 2, 4, 64, 16, heads=True,
            offset=1),
]


def _wkv_bound(c: WkvCase) -> tuple[float, str]:
    """Bytes: r, k, v, wlog, y (BH, T, N), u (BH, N), state in and out
    (BH, N, N), all f32, each once (wkv_heads: r, k, v bf16 and u (H, N)).
    Operations: per chunk of C = 32 steps the four products, y1 (C x N x N),
    the strictly causal A and A v (C (C-1) / 2 x N each) and the state
    update (C x N x N), as 2 ops a multiply-add, and the bonus diagonal
    (3 C N)."""
    BH, T, N, C = c.B * c.H, c.T, c.N, 32
    if c.heads:
        moved = (2 * 3 * BH * T * N
                 + 4 * (2 * BH * T * N + c.H * N + 2 * BH * N * N))
    else:
        moved = 4 * (5 * BH * T * N + BH * N + 2 * BH * N * N)
    ops = BH * (T // C) * (4 * C * N * N + 2 * C * (C - 1) * N + 3 * C * N)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def check_wkv(torch) -> dict:
    from repro_torch.kernels import wkv

    phase("3b WKV kernel against its plain version (on the card)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = None
    for c in WKV_CASES:
        B, H, BH, T, N = c.B, c.H, c.B * c.H, c.T, c.N
        lo, hi = c.w0
        decay = lambda *shape: -torch.exp(lo + (hi - lo) * torch.rand(
            shape, generator=gen, device="cuda"))
        to_bh = lambda x: x.float().transpose(1, 2).reshape(BH, T, N)
        if c.heads:
            # (B, T, H, N) views of (B, T, H * N) projections, as time_mix
            # holds them
            r, k, v = (rnd(B * T * H * N + c.offset).bfloat16()[c.offset:]
                       .view(B, T, H, N) for _ in range(3))
            wl = decay(B, T, H, N)
            u = rnd(H, N) * 0.3
            s0 = rnd(B, H, N, N) * 0.1
            args = (r, k, v, wl, u, s0)
            call = wkv.wkv_heads
            u_rows = u[None].expand(B, H, N).reshape(BH, N)

            def plain():
                y, s = wkv.wkv_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(wl),
                                   u_rows, s0.reshape(BH, N, N))
                return (y.reshape(B, H, T, N).transpose(1, 2),
                        s.reshape(B, H, N, N))
            strides = [(x.stride(0), x.stride(2), x.stride(1))
                       for x in (r, k, v, wl)]
        else:
            r, k, v = rnd(BH, T, N), rnd(BH, T, N), rnd(BH, T, N)
            wl = decay(BH, T, N)
            u = (rnd(H, N) * 0.3)[None].expand(B, H, N).reshape(BH, N)
            s0 = rnd(BH, N, N) * 0.1
            args = (r, k, v, wl, u, s0)
            call = wkv.wkv
            plain = lambda: wkv.wkv_ref(*args)
            strides = [(0, x.stride(0), x.stride(1)) for x in (r, k, v, wl)]
        part = wkv.partition(BH, N, sms, r.element_size())
        route = wkv.route([(x.data_ptr(), st, x.element_size())
                           for x, st in zip((r, k, v, wl), strides)])
        kern = lambda: call(*args)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = all(bool(((g - w).abs() <= c.tol + c.tol * w.abs()).all())
                 for g, w in zip(got, want))
        rec = {"case": c.name, "kernel": "wkv", "shape": [B, H, T, N],
               "ms_slice": part.ms, "blocks": part.blocks, "route": route,
               "max_abs_err": err, "tol": c.tol,
               "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": None}  # no PyTorch call computes WKV
        rec["bound_ms"], rec["bound_by"] = _wkv_bound(c)
        extra = ""
        if c.name.startswith(("path", "reference (1, 2")):
            # both slice widths, so that the partition's pick is measured
            for ms in wkv.SLICES:
                alt = lambda: call(*args, ms=ms)
                g2 = alt()
                torch.cuda.synchronize()
                e2 = max((g - w).abs().max().item()
                         for g, w in zip(g2, want))
                if not all(bool(((g - w).abs() <= c.tol + c.tol * w.abs())
                                .all()) for g, w in zip(g2, want)):
                    raise SystemExit(f"wkv case {c.name!r} at ms={ms} "
                                     f"disagrees: max abs error {e2}")
                extra += f" ms{ms}_ms={time_ms(torch, alt):.4f}"
        if c.name == "path B4 H40 T128 N64":
            # the layout copies time_mix made around the launch before it
            # read (B, T, H, N) in place: r, k, v (bf16) and the log decay
            # (f32) to (B*H, T, N) f32, and y back; the path no longer pays
            # them
            x16 = torch.randn((B, T, H, N), device="cuda").bfloat16()
            x32 = x16.float()
            y = r.clone()

            def layout():
                for x in (x16, x16, x16, x32):
                    to_bh(x)
                y.reshape(B, H, T, N).transpose(1, 2).reshape(B, T, H * N)
            rec["layout_ms"] = time_ms(torch, layout)
            extra += f" old layout copies ms={rec['layout_ms']:.4f}"
        if c.name.startswith("path heads"):
            record = rec
        print(f"wkv    {c.name:34s} ms_slice={part.ms} blocks={part.blocks} "
              f"route={route} err={err:.3g} tol={c.tol} (rtol = atol) "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms=null bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}){extra}", flush=True)
        if not ok:
            raise SystemExit(f"wkv case {c.name!r} disagrees with its plain "
                             f"version beyond rtol = atol = {c.tol}: max "
                             f"abs error {err}")
        del args, got, want
    return record


# ------------------------------------------------------------ phase 4
def _free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _spread(ms: list[float]) -> str:
    return (f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}, max "
            f"{max(ms):.2f})")


def _clone(state):
    from repro_torch import interop

    return interop.tree_map(lambda t: t.clone(), state)


def _restore(state, saved) -> None:
    from repro_torch import interop

    for (_, t), (_, s) in zip(interop.tree_items(state),
                              interop.tree_items(saved)):
        t.copy_(s)


def _differ(torch, a, b) -> list[str]:
    """Names of the leaves of two state trees that are not equal bit for
    bit."""
    from repro_torch import interop

    return [name for (name, x), (_, y) in zip(interop.tree_items(a),
                                              interop.tree_items(b))
            if not torch.equal(x, y)]


def replay_vs_eager(torch, name: str, captured, raw, params, state,
                    *inputs) -> None:
    """One step replayed from its graph and the same step run eagerly from
    the same state: logits and state equal bit for bit, or the run fails.
    Captures the step first where its bucket has no graph yet."""
    from repro_torch.train import graphs

    saved = _clone(state)
    key = tuple((tuple(graphs.as_tensor(x).shape),
                 graphs.as_tensor(x).dtype) for x in inputs)
    if key not in captured.graphs:
        captured(params, state, *inputs)
        _restore(state, saved)
    out = captured(params, state, *inputs).clone()
    after = _clone(state)
    _restore(state, saved)
    want = raw(params, state, *(graphs.as_tensor(x).cuda() for x in inputs))
    torch.cuda.synchronize()
    bad = _differ(torch, after, state)
    same = torch.equal(out, want)
    print(f"  {name}: replay == eager bit for bit: logits {same}, state "
          + ("all leaves" if not bad else f"differs in {bad}"), flush=True)
    if not same or bad:
        raise SystemExit(f"{name}: the replayed step differs from the eager "
                         "step")


def static_steps(torch, arch: str, label: str) -> None:
    """The static server's decode step, eager and as a CUDA-graph replay,
    in one run from one state: step ms (CUDA events between steps, so the
    host's dispatch shows), tok/s, and the replay against the eager step
    bit for bit."""
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_model
    from repro_torch.core.plancache import PlanCache
    from repro_torch.train.servestep import make_serve_step

    phase(f"{label} static decode step of {arch}: eager, then CUDA-graph "
          "replays, from one state")
    cfg = C.get_config(arch)
    V = cfg.vocab_size
    params = models.init(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, size=(BATCH, PROMPT))).cuda()
    max_len = PROMPT + GEN + 1
    steps = 6   # 2 warm + 6 eager + 1 capture + 6 replays + 1 = GEN steps
    with use_context(plan_cache=PlanCache()):
        plan_model(cfg, batch=BATCH, prompt_len=PROMPT, max_len=max_len)
        art = make_serve_step(cfg, device="cuda")
        state = models.init_decode_state(cfg, BATCH, max_len, device="cuda")
        logits = art.prefill_fn(params, state, prompts)

        def loop(fn, n):
            nonlocal logits
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(n + 1)]
            for i in range(n):
                marks[i].record()
                logits = fn(params, state, logits[:, :V].argmax(-1)[:, None])
            marks[n].record()
            torch.cuda.synchronize()
            return [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]

        loop(art.decode_raw, 2)
        eager = loop(art.decode_raw, steps)
        t0 = time.perf_counter()
        loop(art.decode_fn, 1)
        capture_s = time.perf_counter() - t0
        graph = loop(art.decode_fn, steps)
        print(f"eager step {_spread(eager)} = "
              f"{BATCH * 1e3 / statistics.median(eager):.1f} tok/s; graph "
              f"replay {_spread(graph)} = "
              f"{BATCH * 1e3 / statistics.median(graph):.1f} tok/s "
              f"({statistics.median(eager) / statistics.median(graph):.2f}x;"
              f" first call + capture {capture_s:.2f}s)", flush=True)
        replay_vs_eager(torch, "decode step", art.decode_fn, art.decode_raw,
                        params, state, logits[:, :V].argmax(-1)[:, None])
    del params, state, art
    _free(torch)


def run_path(torch, arch: str, label: str) -> dict[str, int]:
    from repro_torch.launch import serve
    from repro_torch.train import graphs

    spec = PATHS[arch]
    phase(f"{label} path: repro_torch.launch.serve --arch {arch} --batch "
          f"{BATCH} --prompt-len {PROMPT} --gen {GEN} (full width and depth)")
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(["--arch", arch, "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--gen", str(GEN),
                      "--plan-cache", ""])
    wall = time.perf_counter() - t0
    # eager launches (prefill, the decode step's first call) plus those of
    # the decode graph's replays
    counts = graphs.launches()
    replayed = dict(graphs.replayed)
    gen = res["generated"]
    print(f"tokens generated {res['tokens']} in {res['seconds']:.3f}s serving "
          f"({res['tokens'] / res['seconds']:.2f} tok/s), {wall:.1f}s with "
          f"init and warm-up; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches: {counts}, of which graph replays {replayed} (rule: "
          f"{spec['want']})")
    if res["lazy_solves"] or res["misses"]:
        raise SystemExit(f"serving was not plan-warm: {res}")
    if counts != spec["want"]:
        raise SystemExit(f"launch counts {counts} differ from the dispatch "
                         f"rule's {spec['want']}")
    if tuple(gen.shape) != (BATCH, GEN) or not (
            (gen >= 0) & (gen < spec["vocab"])).all():
        raise SystemExit(f"bad generated ids {gen.shape}: {gen}")
    del res
    _free(torch)
    return counts


# ------------------------------------------------------------ phase 5
def kernel_vs_plain(torch, arch: str, label: str) -> None:
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import interop, models

    phase(f"{label} kernel path (card) against plain path (CPU), {arch}, "
          "2 layers, full width")
    cfg = dataclasses.replace(C.get_config(arch), n_layers=2)
    params = {"cuda": models.init(cfg, seed=1, device="cuda")}
    params["cpu"] = interop.tree_map(lambda t: t.cpu(), params["cuda"])
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)))
    logits = {}
    fed = []  # the card's greedy tokens, fed to both paths
    for dev in ("cuda", "cpu"):
        state = models.init_decode_state(cfg, BATCH, PROMPT + 5, device=dev)
        lg, state = models.prefill(params[dev], {"tokens": prompts.to(dev)},
                                   cfg, state)
        steps = [lg[:, :cfg.vocab_size].float().cpu()]
        for i in range(4):
            if dev == "cuda":
                fed.append(steps[-1].argmax(-1))
            lg, state = models.decode_step(params[dev], fed[i][:, None].to(dev),
                                           cfg, state)
            steps.append(lg[:, :cfg.vocab_size].float().cpu())
        logits[dev] = torch.stack(steps)
    # bf16 activations: the two paths sum each product in another order, so
    # an activation may round to the neighbouring bf16 value and the flip
    # propagates through 2 layers. Held like the repo's bf16 kernel tests:
    # |card - cpu| <= tol + tol * |cpu| with tol = 5e-2 (on the CPU, the
    # qwen config with a 503-token vocabulary drifted 0.028 at most between
    # f32 and f64 accumulation).
    ref = logits["cpu"]
    diff = (logits["cuda"] - ref).abs()
    err = diff.max().item()
    scaled = (diff / (1 + ref.abs())).max().item()
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > PATH_TOL * (1 + top2[..., 0].abs())
    same = logits["cuda"].argmax(-1) == ref.argmax(-1)
    print(f"logits max |card - cpu| = {err:.4g}, max |card - cpu| / (1 + "
          f"|cpu|) = {scaled:.4g} (tol {PATH_TOL}); greedy tokens equal at "
          f"{int((same & sure).sum())}/{int(sure.sum())} positions whose "
          f"top-2 margin exceeds the tolerance ({int(same.sum())}/"
          f"{same.numel()} overall)")
    if not scaled <= PATH_TOL or not bool(same[sure].all()):
        raise SystemExit("kernel path disagrees with the plain path")
    del params
    _free(torch)


# ------------------------------------------------------------ phase 6
def _traced(torch, fn) -> tuple[list, object, float]:
    """Run ``fn`` once under ``torch.profiler``: (device rows (self device
    us, count, name) of kernels and copies, the profile, wall s)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): an operator's row
    # would count its kernels' time a second time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    return rows, prof, wall


def _busy(rows, wall: float) -> tuple[float, float]:
    """(device busy ms, idle share) of a traced run."""
    busy_us = sum(r[0] for r in rows)
    return busy_us / 1e3, 1 - busy_us / 1e6 / wall


def profile_path(torch, arch: str, label: str) -> None:
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_model
    from repro_torch.core.plancache import PlanCache
    from repro_torch.train import graphs
    from repro_torch.train.servestep import make_serve_step

    phase(f"{label} profile: the {arch} path, warm, timed and traced, with "
          "the decode step eager and as CUDA-graph replays")
    cfg = C.get_config(arch)
    params = models.init(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT))).cuda()
    max_len = PROMPT + GEN + 1
    art = make_serve_step(cfg, device="cuda")
    # one state for every run (the graph holds its addresses): prefill
    # rewrites what a run reads
    state = models.init_decode_state(cfg, BATCH, max_len, device="cuda")

    def run(step, events=False):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(GEN + 2)] if events else None
        if marks:
            marks[0].record()
        logits = art.prefill_fn(params, state, prompts)
        for i in range(GEN):
            if marks:
                marks[i + 1].record()
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            logits = step(params, state, tok[:, None])
        if marks:
            marks[-1].record()
        torch.cuda.synchronize()
        return marks

    traced = {}
    with use_context(plan_cache=PlanCache()):
        plan_model(cfg, batch=BATCH, prompt_len=PROMPT, max_len=max_len)
        for name, step in (("eager", art.decode_raw),
                           ("graph", art.decode_fn)):
            run(step)  # warm: kernels loaded, graph captured, allocator full
            t0 = time.perf_counter()
            marks = run(step, events=True)
            wall = time.perf_counter() - t0
            steps = [marks[i].elapsed_time(marks[i + 1])
                     for i in range(1, GEN + 1)]
            graphs.reset_launches()
            rows, prof, twall = _traced(torch, lambda: run(step))
            busy, idle = _busy(rows, twall)
            traced[name] = (rows, prof, graphs.launches())
            print(f"{name:5s} decode step: warm run prefill "
                  f"{marks[0].elapsed_time(marks[1]):.2f} ms, decode step "
                  f"{_spread(steps)}, wall {wall:.3f}s = "
                  f"{BATCH * GEN / wall:.1f} tok/s; traced run wall "
                  f"{twall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
                  f"share {idle:.3f}", flush=True)
    rows, prof, counts = traced["graph"]
    if not any("gemv_" in k for _, _, k in rows):
        # CUPTI gave the replays without their kernels: the busy time above
        # still holds them; the breakdown comes from the eager run
        print("the traced graph run shows no GEMV kernel rows: CUPTI "
              "reports each replay as one entry on this card; the kernel "
              "breakdown below is the eager run's")
        rows, prof, counts = traced["eager"]
    busy_us = sum(r[0] for r in rows)
    for t, n, key in sorted(rows, reverse=True)[:14]:
        if t:
            print(f"  {t / 1e3:9.2f} ms {100 * t / busy_us:5.1f}% x{n:<5d} "
                  f"{key[:90]}")
    # the fat GEMM kernel by route: on these paths the tensor-core route
    # runs at prefill (M = 512) and split-K at decode (M = 4)
    fat = {name: (sum(t for t, _, k in rows if name in k) / 1e3,
                  sum(n for _, n, k in rows if name in k))
           for name in ("mm_wgmma", "mm_split_k", "mm_core")}
    print("fat GEMM device ms (launches): " + ", ".join(
        f"{name} {ms:.2f} ({n})" for name, (ms, n) in fat.items())
        + f", all {sum(ms for ms, _ in fat.values()):.2f}")
    # the GEMV by kernel name (route, rows a thread holds, types): one
    # kernel launch per decode_matvec call (eager or replayed), the split-K
    # sum inside it
    gemv = {}
    for t, n, key in rows:
        if "gemv_" in key or "sum_splits" in key:
            name = key.replace("(anonymous namespace)::", "").split("(")[0]
            ms, cnt = gemv.get(name, (0.0, 0))
            gemv[name] = (ms + t / 1e3, cnt + n)
    for name, (ms, n) in sorted(gemv.items(), key=lambda kv: -kv[1][0]):
        print(f"  GEMV {ms:9.2f} ms x{n:<5d} {name[:90]}")
    n_gemv = sum(n for _, n in gemv.values())
    print(f"GEMV device ms {sum(ms for ms, _ in gemv.values()):.2f}, kernel "
          f"launches {n_gemv} for {counts['gemv']} decode_matvec calls")
    if n_gemv != counts["gemv"] or any("sum_splits" in k for k in gemv):
        raise SystemExit("the GEMV did not run one kernel launch per call")
    # WKV: its device time, and the kernels the device ran just before and
    # just after each launch: time_mix hands it (B, T, H, N) views, so no
    # layout copy may stand beside it
    wkv_ms = sum(t for t, _, k in rows if "wkv_kernel" in k) / 1e3
    wkv_n = sum(n for _, n, k in rows if "wkv_kernel" in k)
    if wkv_n:
        dev = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        names = [e.name for e in dev]
        short = lambda nm: nm.replace("(anonymous namespace)::", "").split(
            "<")[0].split("(")[0][-48:]
        beside = [names[j] for i, nm in enumerate(names) if "wkv_kernel" in nm
                  for j in (i - 1, i + 1) if 0 <= j < len(names)]
        copies = [nm for nm in beside if "copy" in nm.lower()]
        kinds = sorted({short(nm) for nm in beside})
        print(f"WKV device ms {wkv_ms:.3f} (launches {wkv_n}); kernels "
              f"beside its launches: {kinds}; copy kernels among them: "
              f"{len(copies)}")
        if copies:
            raise SystemExit(f"layout copies beside the WKV kernel: "
                             f"{sorted(set(map(short, copies)))}")
    del params, state, art, traced, rows, prof
    _free(torch)


# ------------------------------------------------------------ phase 7
def _engine_rule(dispatches) -> dict[str, int]:
    """Launches the dispatch rule implies for the engine steps that ran."""
    steps = sum(dispatches.values())
    return {k: n * steps for k, n in ENGINE_STEP.items()}


def run_engine(torch, profile: bool) -> dict[str, int]:
    import numpy as np

    from repro_torch.core.context import use_context
    from repro_torch.launch import serve
    from repro_torch.serve import Request
    from repro_torch.train import graphs

    phase("7 engine path: repro_torch.launch.serve " + " ".join(
        a if a else "''" for a in ENGINE_ARGS) + " (full width and depth)")
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(ENGINE_ARGS)
    wall = time.perf_counter() - t0
    counts = graphs.launches()
    replayed = dict(graphs.replayed)
    engine, m, trace = res["engine"], res["metrics"], res["trace"]
    cfg = engine.cfg
    want = _engine_rule(engine.dispatches)
    print(f"steps {dict(engine.dispatches)}; launches {counts}, of which "
          f"graph replays {replayed} (rule: {want}); graphs captured: "
          f"decode {len(engine.art.decode_fn.graphs)}, prefill chunk "
          f"{len(engine.art.prefill_fn.graphs)}")
    if res["lazy_solves"] or res["misses"]:
        raise SystemExit(f"engine serving was not plan-warm: "
                         f"{m.plan_cache}")
    if counts != want:
        raise SystemExit(f"engine launch counts {counts} differ from the "
                         f"dispatch rule's {want}")
    done = engine.finished
    if len(done) != len(trace) or not all(
            st.finish_reason == "length"
            and len(st.tokens) == st.request.budget(engine.max_len)
            and all(0 <= t < cfg.vocab_size for t in st.tokens)
            for st in done):
        raise SystemExit(f"engine: {len(done)} of {len(trace)} requests "
                         "finished, or a bad token id")

    def report(tag, met, ticks_ms=None):
        slo = met.slo_summary()["0"]
        bp = met.block_pool
        print(f"{tag}: {met.generated_tokens} tokens in {met.wall_s:.3f}s ="
              f" {met.tokens_per_sec:.1f} tok/s; TTFT p50 "
              f"{1e3 * slo['p50_ttft_s']:.1f} ms, p99 "
              f"{1e3 * slo['p99_ttft_s']:.1f} ms; {met.ticks} ticks "
              f"({1e3 * met.wall_s / met.ticks:.2f} ms a tick on the host "
              f"clock), {met.admissions} admissions, pool peak "
              f"{bp['peak_in_use']}/{bp['num_blocks'] - 1} blocks"
              + ("" if not ticks_ms else
                 f"; decode tick on the card {_spread(ticks_ms)}"),
              flush=True)

    report(f"first run (graphs captured in it; {wall:.1f}s with init and "
           "warm-up)", m)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")

    # the reruns and checks under the run's context (its warm plans)
    with use_context(res["context"]):
        # a warm rerun of the same trace: every step a replay, decode ticks
        # timed with CUDA events around the call (input copies, replay)
        again = lambda: [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                         for r in trace]
        decode = engine.art.decode_fn
        marks = []

        def timed(*args):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = decode(*args)
            ev[1].record()
            marks.append(ev)
            return out

        engine.art.decode_fn = timed
        engine.reset()
        graphs.reset_launches()
        m2 = engine.run(again())
        engine.art.decode_fn = decode
        counts2, want2 = graphs.launches(), _engine_rule(engine.dispatches)
        report("warm rerun", m2, [a.elapsed_time(b) for a, b in marks])
        if counts2 != want2 or m2.plan_cache["lazy_solves"] or \
                m2.plan_cache["misses"]:
            raise SystemExit(f"warm rerun: launches {counts2} (rule {want2}), "
                             f"plan cache {m2.plan_cache}")
        if profile:
            engine.reset()
            rows, _, twall = _traced(torch, lambda: engine.run(again()))
            busy, idle = _busy(rows, twall)
            print(f"traced rerun: wall {twall * 1e3:.1f} ms, device busy "
                  f"{busy:.1f} ms, idle share {idle:.3f}")
            busy_us = sum(r[0] for r in rows)
            for t, n, key in sorted(rows, reverse=True)[:10]:
                if t:
                    print(f"  {t / 1e3:9.2f} ms {100 * t / busy_us:5.1f}% "
                          f"x{n:<5d} {key[:90]}")

        # replay against eager, bit for bit: a decode tick with every lane live
        # on distinct blocks, and one chunk of each bucket into lane 0 (one pad
        # position, whose write goes to the null block)
        print("replayed steps against the same steps run eagerly:")
        art, kv = engine.art, engine.state["kv"]
        lanes, per = engine.num_slots, (engine.num_kv_blocks - 1) \
            // engine.num_slots
        bs = engine.kv_block_size
        table = np.zeros((lanes, art.max_blocks), np.int32)
        for s in range(lanes):
            table[s, :per] = 1 + s * per + np.arange(per)
        kv.table.copy_(torch.from_numpy(table))
        kv.length.copy_(torch.arange(per * bs - 1, per * bs - 1 - lanes, -1,
                                     dtype=torch.int32))
        rng = np.random.default_rng(7)
        replay_vs_eager(torch, f"decode tick ({lanes} lanes)", art.decode_fn,
                        art.decode_raw, engine.params, engine.state,
                        rng.integers(0, cfg.vocab_size, (lanes, 1)),
                        np.ones(lanes, np.int64))
        for bucket in art.chunk_buckets:
            replay_vs_eager(torch, f"prefill chunk @{bucket}", art.prefill_fn,
                            art.prefill_raw, engine.params, engine.state,
                            rng.integers(0, cfg.vocab_size, (1, bucket)), 0, 0,
                            bucket - 1, table[0].astype(np.int64))
    del res, engine, m, m2, art, kv
    _free(torch)
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))

    smi = environment(torch)
    build_kernels()
    record = check_kernels(torch)
    record["wkv"] = check_wkv(torch)
    profile = "--profile" in sys.argv[1:]
    counts = {"qwen1.5-4b": run_path(torch, "qwen1.5-4b", "4a")}
    static_steps(torch, "qwen1.5-4b", "4a")
    kernel_vs_plain(torch, "qwen1.5-4b", "5a")
    counts["rwkv6-3b"] = run_path(torch, "rwkv6-3b", "4b")
    static_steps(torch, "rwkv6-3b", "4b")
    kernel_vs_plain(torch, "rwkv6-3b", "5b")
    if profile:
        profile_path(torch, "qwen1.5-4b", "6a")
        profile_path(torch, "rwkv6-3b", "6b")
    counts["qwen1.5-4b engine"] = run_engine(torch, profile)

    src = {"matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:193"),
           "gemv": ("src/repro_torch/kernels/csrc/decode_matvec.cu",
                    "src/repro/kernels/decode_matvec.py:83"),
           "wkv": ("src/repro_torch/kernels/csrc/wkv.cu",
                   "src/repro/kernels/wkv.py:86")}
    kernels = []
    for name in ("matmul", "gemv", "wkv"):
        r = record[name]
        by_path = {arch: c[name] for arch, c in counts.items() if c[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": sum(by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "shape": r["shape"],
            "launches_by_path": by_path})
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
