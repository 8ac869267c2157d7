#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port (``src/repro_torch``) runs on one H100.

  python3 chip_smoke.py            # phases 1-5; needs one CUDA card
  python3 chip_smoke.py --profile  # and phase 6, the time breakdown

Two paths, each at a model's full width and depth with random weights:
qwen1.5-4b (dense; the fat GEMM and GEMV kernels) and rwkv6-3b (RWKV-6;
the same two and the WKV kernel). Phases, in order; any failure ends the
run with a non-zero exit:

1. environment: card name and power limit, torch and CUDA versions,
   compute capability (9, 0) required; TF32 off for the plain versions;
2. build: the three CUDA sources under ``src/repro_torch/kernels/csrc``
   with nvcc, in parallel;
3. kernels: each kernel at its path's shapes (batch 4, prompt 128) against
   its plain PyTorch version on the same inputs, with its time, its bound,
   the plain version's time and one library call's time where there is
   one (3a: the GEMMs; 3b: WKV, whose layout copies are timed too);
4. path (4a qwen1.5-4b, 40 layers; 4b rwkv6-3b, 32 layers):
   ``repro_torch.launch.serve --arch ARCH --batch 4 --prompt-len 128
   --gen 16`` with the plan warm-up; zero lazy solves, and launch counts
   equal to what the dispatch rule implies, counted from 0 for each path;
5. kernel path against plain path (5a qwen, 5b rwkv): the config cut to 2
   layers, prefill plus 4 decode steps on the card and on the CPU from the
   same weights, logits held to a stated tolerance (rwkv's 128-token
   prefill takes the WKV kernel);
6. with ``--profile`` only: each phase 4 path again with everything warm,
   prefill and decode steps timed with CUDA events, then once more under
   ``torch.profiler``: device time by kernel and the device's idle share.

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
    reading a 64 MiB buffer so that no operand starts in the 50 MB L2 (the
    main path streams 15.8 GB of weights a step: they are always cold). A
    read leaves no dirty lines whose write-back the timed call would pay."""
    flush = torch.ones(64 * 2**20, dtype=torch.uint8, device="cuda")
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
    Case("int8 requant -> int8", "matmul", 512, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int8", bias=True, scale=True),
    Case("ragged + gelu", "matmul", 333, 1000, 777, bias=True,
         activation="gelu"),
    Case("decode wo", "gemv", 4, 2560, 2560),
    Case("decode w_in", "gemv", 4, 2560, 6912),
    Case("decode w_out", "gemv", 4, 6912, 2560),
    Case("unembed f32 out", "gemv", 4, 2560, 151936, out_dtype="float32"),
    Case("col layout", "gemv", 4, 2560, 2560, layout="col"),
    Case("ragged", "gemv", 3, 1000, 777),
]
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
        return lambda: torch._int_mm(a, bt)
    if bias is not None:
        return lambda: torch.addmm(bias, a.float(), bt.float())
    return lambda: torch.mm(a.float(), bt.float())


def _bound(c: Case, torch) -> tuple[float, str]:
    size = lambda name: getattr(torch, name).itemsize
    moved = (c.M * c.K * size(c.a_dtype) + c.K * c.N * size(c.b_dtype)
             + c.M * c.N * size(c.out_dtype)
             + 4 * c.N * (int(c.bias) + int(c.scale)))
    ops = 2 * c.M * c.K * c.N
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS["int8" if c.a_dtype == "int8" else "float32"]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def check_kernels(torch) -> dict[str, dict]:
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_for
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import ops, ref

    phase("3a GEMM kernels against their plain versions (on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    with use_context(hw="h100", plan_cache=PlanCache()):
        for c in CASES:
            a, b, bias, scale = _inputs(torch, c, gen)
            out_dtype = getattr(torch, c.out_dtype)
            plan = plan_for(c.M, c.K, c.N, in_dtype=a.dtype,
                            out_dtype=out_dtype, b_layout=c.layout)
            if c.kernel == "matmul":
                kern = lambda: ops.balanced_matmul(
                    a, b, bias, plan=plan, out_dtype=out_dtype,
                    b_layout=c.layout, activation=c.activation,
                    out_scale=scale)
                plain = lambda: ref.matmul_ref(
                    a, b, out_dtype=out_dtype, b_layout=c.layout, bias=bias,
                    activation=c.activation, out_scale=scale)
            else:
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
            # largest value; an int8 requant result may flip one rint tie.
            if c.out_dtype == "bfloat16":
                tol = 2.0 ** -7 * max(1.0, peak)
            elif c.out_dtype == "float32":
                tol = 1e-5 * max(1.0, peak)
            else:
                tol = 1.0
            lib = _library_call(torch, c, a, b, bias)
            rec = {
                "case": c.name, "kernel": c.kernel,
                "shape": [c.M, c.K, c.N], "layout": c.layout,
                "dtypes": [c.a_dtype, c.b_dtype, c.out_dtype],
                "plan": [plan.bm, plan.bk, plan.bn],
                "max_abs_err": err, "tol": tol,
                "ms": time_ms(torch, kern),
                "plain_ms": time_ms(torch, plain),
                "library_ms": None if lib is None else time_ms(torch, lib),
            }
            rec["bound_ms"], rec["bound_by"] = _bound(c, torch)
            results.append(rec)
            print(f"{c.kernel:6s} {c.name:22s} MKN={c.M}x{c.K}x{c.N} "
                  f"{c.layout} plan={rec['plan']} err={err:.3g} "
                  f"tol={tol:.3g} ms={rec['ms']:.4f} "
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


# the rwkv6-3b path's shape (batch 4 x 40 heads of 64, prompt 128), the
# reference test's shapes (tests/test_kernels_wkv.py) and its adversarial
# decay range; tolerances are that test's: rtol = atol = 2e-4, and 1e-3
# for the adversarial range (decays down to e^-3.3 a step re-centred over
# a chunk: the factored exponentials lose a few more bits)
WKV_CASES = [
    WkvCase("path B4 H40 T128 N64", 4, 40, 128, 64),
    WkvCase("reference (1, 2, 96, 128)", 1, 2, 96, 128),
    WkvCase("reference (1, 1, 32, 64)", 1, 1, 32, 64),
    WkvCase("adversarial decay (1, 2, 64, 32)", 1, 2, 64, 32,
            w0=(-8.0, 1.2), tol=1e-3),
]


def _wkv_bound(c: WkvCase) -> tuple[float, str]:
    """Bytes: r, k, v, wlog, y (BH, T, N), u (BH, N), state in and out
    (BH, N, N), all f32, each once. Operations: per chunk of C = 32 steps
    the four products, y1 (C x N x N), the strictly causal A and A v
    (C (C-1) / 2 x N each) and the state update (C x N x N), as 2 ops a
    multiply-add, and the bonus diagonal (3 C N)."""
    BH, T, N, C = c.B * c.H, c.T, c.N, 32
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
    record = None
    for c in WKV_CASES:
        BH, T, N = c.B * c.H, c.T, c.N
        r, k, v = rnd(BH, T, N), rnd(BH, T, N), rnd(BH, T, N)
        lo, hi = c.w0
        wl = -torch.exp(lo + (hi - lo) * torch.rand(
            (BH, T, N), generator=gen, device="cuda"))
        u = (rnd(c.H, N) * 0.3)[None].expand(c.B, c.H, N).reshape(BH, N)
        s0 = rnd(BH, N, N) * 0.1
        args = (r, k, v, wl, u, s0)
        kern = lambda: wkv.wkv(*args)
        plain = lambda: wkv.wkv_ref(*args)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = all(bool(((g - w).abs() <= c.tol + c.tol * w.abs()).all())
                 for g, w in zip(got, want))
        rec = {"case": c.name, "kernel": "wkv", "shape": [c.B, c.H, T, N],
               "max_abs_err": err, "tol": c.tol,
               "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": None}  # no PyTorch call computes WKV
        rec["bound_ms"], rec["bound_by"] = _wkv_bound(c)
        if record is None:
            # the layout copies time_mix makes around the launch at this
            # shape: r, k, v (bf16) and the log decay (f32) from (B, T, H,
            # N) to (B*H, T, N) f32, and y back
            x16 = torch.randn((c.B, T, c.H, N), device="cuda").bfloat16()
            x32 = x16.float()
            y = r.clone()
            to_bh = lambda x: x.float().transpose(1, 2).reshape(BH, T, N)

            def layout():
                for x in (x16, x16, x16, x32):
                    to_bh(x)
                y.reshape(c.B, c.H, T, N).transpose(1, 2).reshape(
                    c.B, T, c.H * N)
            rec["layout_ms"] = time_ms(torch, layout)
            record = rec
        print(f"wkv    {c.name:34s} err={err:.3g} tol={c.tol} (rtol = atol) "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms=null bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})"
              + (f" layout copies ms={rec['layout_ms']:.4f}"
                 if "layout_ms" in rec else ""), flush=True)
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


def run_path(torch, arch: str, label: str) -> dict[str, int]:
    from repro_torch.kernels import decode_matvec, matmul, wkv
    from repro_torch.launch import serve

    spec = PATHS[arch]
    phase(f"{label} path: repro_torch.launch.serve --arch {arch} --batch "
          f"{BATCH} --prompt-len {PROMPT} --gen {GEN} (full width and depth)")
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = decode_matvec.launches = wkv.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", arch, "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--gen", str(GEN),
                      "--plan-cache", ""])
    wall = time.perf_counter() - t0
    counts = {"matmul": matmul.launches, "gemv": decode_matvec.launches,
              "wkv": wkv.launches}
    gen = res["generated"]
    print(f"tokens generated {res['tokens']} in {res['seconds']:.3f}s serving "
          f"({res['tokens'] / res['seconds']:.2f} tok/s), {wall:.1f}s with "
          f"init and warm-up; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches: {counts} (rule: {spec['want']})")
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
def profile_path(torch, arch: str, label: str) -> None:
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_model
    from repro_torch.core.plancache import PlanCache

    phase(f"{label} profile: the {arch} path, warm, timed and traced")
    cfg = C.get_config(arch)
    params = models.init(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT))).cuda()
    max_len = PROMPT + GEN + 1

    def run(events=None):
        state = models.init_decode_state(cfg, BATCH, max_len, device="cuda")
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(GEN + 2)] if events else None
        if marks:
            marks[0].record()
        logits, state = models.prefill(params, {"tokens": prompts}, cfg,
                                       state)
        for i in range(GEN):
            if marks:
                marks[i + 1].record()
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            logits, state = models.decode_step(params, tok[:, None], cfg,
                                               state)
        if marks:
            marks[-1].record()
        torch.cuda.synchronize()
        return marks

    with use_context(plan_cache=PlanCache()):
        plan_model(cfg, batch=BATCH, prompt_len=PROMPT, max_len=max_len)
        run()  # warm: kernels loaded, library handles made, allocator full
        t0 = time.perf_counter()
        marks = run(events=True)
        wall = time.perf_counter() - t0
        steps = [marks[i].elapsed_time(marks[i + 1])
                 for i in range(1, GEN + 1)]
        print(f"warm run: prefill {marks[0].elapsed_time(marks[1]):.2f} ms, "
              f"decode step median {statistics.median(steps):.2f} ms (min "
              f"{min(steps):.2f}, max {max(steps):.2f}), wall {wall:.3f}s = "
              f"{BATCH * GEN / wall:.1f} tok/s")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): an operator's row
    # would count its kernels' time a second time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_us = sum(r[0] for r in rows)
    print(f"traced run: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    for t, n, key in sorted(rows, reverse=True)[:14]:
        if t:
            print(f"  {t / 1e3:9.2f} ms {100 * t / busy_us:5.1f}% x{n:<5d} "
                  f"{key[:90]}")
    del params
    _free(torch)


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
    counts = {"qwen1.5-4b": run_path(torch, "qwen1.5-4b", "4a")}
    kernel_vs_plain(torch, "qwen1.5-4b", "5a")
    counts["rwkv6-3b"] = run_path(torch, "rwkv6-3b", "4b")
    kernel_vs_plain(torch, "rwkv6-3b", "5b")
    if "--profile" in sys.argv[1:]:
        profile_path(torch, "qwen1.5-4b", "6a")
        profile_path(torch, "rwkv6-3b", "6b")

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
