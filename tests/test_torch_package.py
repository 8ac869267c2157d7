"""Package rules of the port: it imports neither jax nor repro, its CLI
serves on the CPU only when asked to, and it never falls back silently."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
"""


def _run(args, **kw):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300, **kw)


def test_port_imports_neither_jax_nor_repro():
    res = _run([sys.executable, "-c", _IMPORT_ALL.format(root=ROOT)])
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(maxsplit=1)
    assert int(n) >= 20
    assert bad.strip() == "[]"


def test_serve_cli_runs_on_cpu_when_asked():
    res = _run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                "--device", "cpu", "--plan-cache", "", "--gen", "4"])
    assert res.returncode == 0, res.stderr
    assert "lazy_solves=0" in res.stdout
    assert "device=cpu" in res.stdout


def test_serve_cli_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    res = _run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                "--plan-cache", ""])
    assert res.returncode != 0
    assert "CUDA" in res.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run([sys.executable, os.path.join(ROOT, "chip_smoke.py")])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"  # a directory with nothing else
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
