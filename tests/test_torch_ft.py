"""The port's fault-tolerance modules (``ft.checkpoint``, ``ft.straggler``,
``ft.elastic``) and its training launcher, on the CPU: the counterparts of
the reference's tests/test_checkpoint.py and tests/test_ft_and_tuning.py,
and the checkpoint layout read across the two packages.

Checkpoints are exact: every leaf, the bf16 one included (stored as its
uint16 bits), restores bit for bit, and a run resumed from a checkpoint
equals an uninterrupted one bit for bit (the same ops on the same CPU).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.ft import checkpoint as RCK
from repro.ft import straggler as RST
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.data.synthetic import batch_for
from repro_torch.ft import checkpoint as ck
from repro_torch.ft.elastic import resume_on_device
from repro_torch.ft import straggler as TST
from repro_torch.train.trainstep import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_state():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.tensor([1.0, -2.5, 3.0078125, 0.1],
                                     dtype=torch.bfloat16)},
        "opt": {"m": {"w": torch.zeros((3, 4)), "b": torch.zeros((4,))}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _equal(a, b) -> None:
    ia, ib = list(interop.tree_items(a)), list(interop.tree_items(b))
    assert [p for p, _ in ia] == [p for p, _ in ib]
    for (path, x), (_, y) in zip(ia, ib):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.detach(), y.detach()), path


def test_save_restore_roundtrip(tmp_path):
    state = _tiny_state()
    path = ck.save(str(tmp_path), state, 7)
    assert ck.latest_step(str(tmp_path)) == 7
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    kinds = {e["key"]: e["dtype"] for e in manifest["leaves"]}
    assert kinds["params__b"] == "bfloat16"
    assert np.load(os.path.join(path, "params__b.npy")).dtype == np.uint16
    like = interop.tree_map(lambda t: torch.empty_like(t, device="meta"),
                            state)
    _equal(ck.restore(str(tmp_path), 7, like, device="cpu"), state)


def test_gc_keeps_last_three(tmp_path):
    state = _tiny_state()
    for s in range(6):
        ck.save(str(tmp_path), state, s)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 3 and kept[-1] == "step_00000005"


def test_async_checkpointer_snapshots_before_the_state_moves(tmp_path):
    state = _tiny_state()
    ac = ck.AsyncCheckpointer(str(tmp_path))
    ac.save(state, 1)
    state["params"]["w"].add_(1.0)  # the trainer updates in place
    ac.save(state, 2)   # waits for the first write
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 2
    first = ck.restore(str(tmp_path), 1, _tiny_state(), device="cpu")
    assert torch.equal(first["params"]["w"], _tiny_state()["params"]["w"])


def test_restore_shape_mismatch_raises(tmp_path):
    state = _tiny_state()
    ck.save(str(tmp_path), state, 1)
    bad = {**state, "params": {"w": torch.zeros((5, 4)),
                               "b": torch.zeros((4,), dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 1, bad, device="cpu")


def test_restores_a_reference_checkpoint(tmp_path):
    """The layout is the reference's: its checkpoint (a bf16 leaf stored as
    f32) restores into the port's tree bit for bit."""
    state = _tiny_state()
    rstate = {"params": {"w": jnp.asarray(state["params"]["w"].numpy()),
                         "b": jnp.asarray(state["params"]["b"].float()
                                          .numpy(), jnp.bfloat16)},
              "opt": {"m": {"w": jnp.zeros((3, 4)), "b": jnp.zeros((4,))}},
              "step": jnp.asarray(7, jnp.int32)}
    RCK.save(str(tmp_path), rstate, 7)
    _equal(ck.restore(str(tmp_path), 7, state, device="cpu"), state)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """3 steps, a checkpoint, resume, 2 more: the state equals 5 steps run
    without a break, bit for bit; the data resumes from the step."""
    rcfg = RC.smoke(RC.get_config("qwen1.5-4b"))
    cfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    with use_context(plan_cache=PlanCache()):
        art, state, start = resume_on_device(cfg, str(tmp_path),
                                             device="cpu", global_batch=4)
        assert start == 0
        straight = make_train_step(cfg, global_batch=4, device="cpu")
        ref_state = straight.init_fn(0)
        for step in range(5):
            b = batch_for(cfg, 32, 4, step)
            ref_state, _ = straight.step_fn(ref_state, b)
            if step < 3:
                state, _ = art.step_fn(state, b)
        ck.save(str(tmp_path), state, 3)
        art2, state2, start2 = resume_on_device(cfg, str(tmp_path),
                                                device="cpu", global_batch=4)
        assert start2 == 3
        _equal(state2, state)
        for step in range(3, 5):
            state2, metrics = art2.step_fn(state2, batch_for(cfg, 32, 4,
                                                             step))
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2["step"]) == 5
    _equal(state2, ref_state)


# ------------------------------------------------------------- straggler
def _verdicts(mod, times, cfg=None):
    m = mod.StragglerMonitor(cfg)
    return [m.record(s, t) for s, t in enumerate(times)], m.events


STRAGGLER_CASES = {
    # steady state: never acts
    "steady": ([0.1 + 0.001 * (s % 3) for s in range(50)], None),
    # a persistently slow tail escalates
    "persistent": ([0.1] * 20 + [1.5] * 6, dict(patience=3)),
    # one spike warns only
    "one_spike": ([0.1] * 20 + [2.0, 0.1], None),
}


@pytest.mark.parametrize("case", list(STRAGGLER_CASES))
def test_straggler_matches_reference(case):
    times, over = STRAGGLER_CASES[case]
    got, events = _verdicts(
        TST, times, None if over is None else TST.StragglerConfig(**over))
    want, ref_events = _verdicts(
        RST, times, None if over is None else RST.StragglerConfig(**over))
    assert got == want and events == ref_events
    if case == "steady":
        assert set(got) <= {"ok", "warn"}
    elif case == "persistent":
        assert "checkpoint_and_rebalance" in got
    else:
        assert got[-2:] == ["warn", "ok"]


# ------------------------------------------------------------- launcher
def _train(tmp_path, steps: int) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--plan-cache", "", "--steps", str(steps),
         "--batch", "4", "--seq", "32", "--ckpt-every", "4", "--ckpt-dir",
         str(tmp_path / "ck"), "--log-every", "2"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


def test_train_cli_checkpoints_and_resumes_on_cpu(tmp_path):
    first = _train(tmp_path, 6)
    assert first.returncode == 0, first.stderr
    assert "start_step=0" in first.stdout and "device=cpu" in first.stdout
    assert "done: loss" in first.stdout
    assert ck.latest_step(str(tmp_path / "ck")) == 6
    again = _train(tmp_path, 8)
    assert again.returncode == 0, again.stderr
    assert "start_step=6" in again.stdout
    assert "step     6 loss" in again.stdout
    assert ck.latest_step(str(tmp_path / "ck")) == 8
