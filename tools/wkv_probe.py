#!/usr/bin/env python3
"""Where the WKV kernel's time goes, on the card: phase ablations and clock
stamps of ``src/repro_torch/kernels/csrc/wkv.cu``.

  python3 tools/wkv_probe.py                 # every variant, timed
  python3 tools/wkv_probe.py base,noP3       # some of them
  python3 tools/wkv_probe.py base --stamps   # and the phase clock stamps

Each variant is the kernel source with one step removed by a text edit
(its results are wrong; only its time means anything): noP1 the cumsum,
noP2 the decay-scaled tiles, noP3 the three products of step 3, noP4 step
4 (A v and the stores; y1, then unused, goes with it), empty all four.
Every variant is built with nvcc into build/wkv_probe/ and launched through
``kernels.wkv.wkv_heads`` at rwkv6-3b's prefill shape (batch 4, T 128, 40
heads of 64) and three more, each timed as ``chip_smoke.time_ms`` times
the kernels of phase 3b. ``--stamps`` adds a build whose thread 0 (and one
thread of the y and S' warps) records ``clock64()`` at each step of each
chunk for blocks 0-7, and prints them for blocks 0-2: a warp reads the
clock as soon as it reaches a barrier, so a stamp right after one marks
that warp's arrival, not the barrier's release. Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "wkv.cu")
OUT = os.path.join(ROOT, "build", "wkv_probe")

_P1 = [("    if (tid < 2 * N) {\n      const int q = lane & 3",
        "    if (false) {\n      const int q = lane & 3")]
_P2 = [("for (int n = 4 * warp; n < N; n += 4 * (THREADS / 32)) {",
        "for (int n = 4 * warp; n < 0; n += 4 * (THREADS / 32)) {")]
_P3 = [("    if (warp < 2) {\n", "    if (false) {\n"),
       ("    } else if (warp < 4) {\n", "    } else if (false) {\n"),
       ("      for (int s = 0; s < C; ++s) {\n        float kd[SN];",
        "      for (int s = 0; s < 0; ++s) {\n        float kd[SN];")]
_P4 = [("    if (y_role) {\n      float y2", "    if (false) {\n      float y2")]
VARIANTS = {"base": [], "noP1": _P1, "noP2": _P2, "noP3": _P3, "noP4": _P4,
            "empty": _P1 + _P2 + _P3 + _P4}

# (slot, who, text, context after it): slot k of chunk c is
# g_stamps[block][1 + 16 c + k], recorded right after the text
STAMPS = [
    (0, "tid == 0", "__syncthreads();  // the chunk is staged; the last chunk's products are done\n", ""),
    (1, "tid == 0", "        st4(MID + n, mid);\n      }\n    }\n", ""),
    (2, "tid == 0", "    __syncthreads();\n", "\n    // 2. the decay-scaled"),
    (3, "tid == 0", "      st4(KD + t * L::LDK + n, make_float4(kd[0], kd[1], kd[2], kd[3]));\n    }\n", ""),
    (4, "tid == 0", "    __syncthreads();\n", "\n    // the staging area is free"),
    (5, "tid == 0", "    if (t0 + C < p.T) stage(t0 + C);\n", ""),
    (6, "tid == 0", "        st4(AT + s * C + 4 * ta, make_float4(a[0], a[1], a[2], a[3]));\n      }\n", ""),
    (7, "tid == 64", "          sv = svn;\n        }\n      }\n", ""),
    (8, "tid == 128", "        for (int j = 0; j < 4; ++j) hold[4 * i + j] += acc[i][j];\n", ""),
    (9, "tid == 0", "__syncthreads();  // A is complete; every read of S is done\n", ""),
    (10, "tid == 64", "        for (int j = 0; j < 4; ++j) hold[4 * i + j] = 0.f;\n      }\n", ""),
]
STAMP_NAMES = ["bar0", "scan", "bar1", "tiles", "bar2", "stage", "A", "y1",
               "S'", "bar3", "y"]
SHAPES = [(4, 128, 40, 64), (4, 32, 40, 64), (1, 128, 40, 64),
          (4, 128, 40, 64, "float32")]


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"wkv_probe: the kernel source changed; no "
                             f"single match for {old!r}")
        src = src.replace(old, new)
    return src


def variant_source(name: str) -> str:
    src = open(SRC).read()
    if name != "stamps":
        return _edit(src, VARIANTS[name])
    rec = ("if ({who} && blockIdx.x < 8) g_stamps[blockIdx.x][1 + (t0 / C) "
           "* 16 + {k}] = clock64();\n")
    edits = [("template <typename Tin, int N, int MS>\nconstexpr int min_blocks()",
              "__device__ long long g_stamps[8][72];\n"
              "template <typename Tin, int N, int MS>\nconstexpr int min_blocks()"),
             ("  if (p.T > 0) stage(0);\n",
              "  if (tid == 0 && blockIdx.x < 8) g_stamps[blockIdx.x][0] = "
              "clock64();\n  if (p.T > 0) stage(0);\n"),
             ("#elif REPRO_PART == 3\n",
              "#elif REPRO_PART == 3\nextern \"C\" int probe_stamps(long long* "
              "host) {\n  return cudaMemcpyFromSymbol(host, g_stamps, "
              "sizeof(g_stamps));\n}\n")]
    edits += [(text + ctx, text + rec.format(who=who, k=k) + ctx)
              for k, who, text, ctx in STAMPS]
    return _edit(src, edits)


def build(names) -> None:
    from repro_torch.kernels import build as kb

    nvcc = kb._nvcc()
    procs = []
    for n in names:
        d = os.path.join(OUT, n)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "wkv.cu"), "w") as f:
            f.write(variant_source(n))
        for part in range(kb.SOURCES["wkv"]):
            procs.append(subprocess.Popen(
                [nvcc, *kb.COMPILE_FLAGS, f"-DREPRO_PART={part}", "-c", "-o",
                 os.path.join(d, f"p{part}.o"), os.path.join(d, "wkv.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(log)
    for n in names:
        d = os.path.join(OUT, n)
        subprocess.run([nvcc, *kb.ARCH, "-shared", "-o",
                        os.path.join(d, "lib.so"),
                        *(os.path.join(d, f"p{i}.o")
                          for i in range(kb.SOURCES["wkv"]))], check=True)


def _load(name: str):
    lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv.argtypes = [p] * 9 + [i] * 7 + [p, p]
    lib.repro_wkv.restype = i
    return lib


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import wkv

    if not torch.cuda.is_available():
        print("wkv_probe: needs a CUDA card", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    names = args[0].split(",") if args else list(VARIANTS)
    stamps = "--stamps" in sys.argv
    t0 = time.perf_counter()
    build(names + (["stamps"] if stamps else []))
    print(f"built {names} in {time.perf_counter() - t0:.1f}s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(1)

    def heads(B, T, H, N, dtype="bfloat16"):
        rk = [torch.randn((B, T, H * N), generator=gen, device="cuda").to(
            getattr(torch, dtype)).view(B, T, H, N) for _ in range(3)]
        wl = -torch.exp(-6 + 7 * torch.rand((B, T, H, N), generator=gen,
                                            device="cuda"))
        u = torch.randn((H, N), generator=gen, device="cuda") * 0.3
        s0 = torch.randn((B, H, N, N), generator=gen, device="cuda") * 0.1
        return (*rk, wl, u, s0)

    inputs = {s: heads(*s) for s in SHAPES}
    for n in names:
        wkv._lib = lambda lib=_load(n): lib
        row = []
        for s in SHAPES:
            for ms in wkv.SLICES:
                ms_ = cs.time_ms(torch, lambda: wkv.wkv_heads(*inputs[s],
                                                              ms=ms))
                row.append(f"{s[0]}x{s[1]}{'' if len(s) == 4 else ' f32'} "
                           f"ms{ms}={ms_:.4f}")
        print(f"{n:6s} " + " ".join(row), flush=True)
    if stamps:
        import numpy as np

        lib = _load("stamps")
        lib.probe_stamps.argtypes = [ctypes.c_void_p]
        lib.probe_stamps.restype = ctypes.c_int
        wkv._lib = lambda: lib
        for s in SHAPES[::2]:
            for _ in range(3):
                wkv.wkv_heads(*inputs[s], ms=32)
            torch.cuda.synchronize()
            buf = np.zeros((8, 72), np.int64)
            if lib.probe_stamps(buf.ctypes.data) != 0:
                raise SystemExit("wkv_probe: reading the stamps failed")
            for blk in range(3):
                for c in range(s[1] // 32):
                    seg = buf[blk, 1 + 16 * c: 12 + 16 * c] - buf[blk, 0]
                    print(f"stamps {s[0]}x{s[1]} block {blk} chunk {c}: " +
                          " ".join(f"{k}={v}" for k, v in
                                   zip(STAMP_NAMES, seg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
