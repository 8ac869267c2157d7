"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes one shared
library, ``lib<name>-<hash>.so``, in the build directory (``build/repro_torch``
at the checkout root, or ``$REPRO_TORCH_BUILD_DIR``). A source is compiled
once per part (``-DREPRO_PART=0..PARTS-1``: its kernel instantiations split
by input type, part 0 the C entry point), every part of every source in its
own ``nvcc`` process, all started together; the objects are then linked. The
hash covers the source and the flags, so an edited source is rebuilt and
never stale. Nothing is built or loaded at import: the first launch builds,
or ``build_all()`` compiles everything at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"matmul": 10, "decode_matvec": 7, "wkv": 5}  # name -> parts
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch are built from source on the machine with the "
            "card")
    return nvcc


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(COMPILE_FLAGS) + f" parts={SOURCES[name]}"
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def _run_all(cmds: dict) -> dict:
    """Run the commands in parallel; {key: combined output}. Raises with
    the compiler's output if any fails."""
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{logs[k]}")
    return logs


def build_all(names=tuple(SOURCES)) -> dict[str, str]:
    """Build every source not yet built. Returns {name: compiler log} (the
    ptxas register / shared-memory / spill report of every kernel)."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        obj = lambda n, p: os.path.join(tmp, f"{n}.{p}.o")
        logs = _run_all({
            (n, p): [nvcc, *COMPILE_FLAGS, f"-DREPRO_PART={p}", "-c", "-o",
                     obj(n, p), str(CSRC / f"{n}.cu")]
            for n in todo for p in range(SOURCES[n])})
        libs = {n: os.path.join(tmp, f"lib{n}.so") for n in todo}
        _run_all({n: [nvcc, *ARCH, "-shared", "-o", libs[n],
                      *(obj(n, p) for p in range(SOURCES[n]))]
                  for n in todo})
        for n in todo:
            os.replace(libs[n], _lib_path(n))
    return {n: "".join(logs[(n, p)] for p in range(SOURCES[n])) for n in todo}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    build_all((name,))
    return ctypes.CDLL(str(_lib_path(name)))


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")
