"""The port's per-slot and paged decode state against the reference's, on
the CPU, from the same weights (``interop.params_from_jax``) and the same
lengths and block tables.

qwen1.5-4b-smoke (2 layers, d_model 64) at f32 and with bf16 activations.
Tolerances are ``tests/test_torch_lm.py``'s: with f32 activations the two
sides differ in summation order only (rtol = atol = 1e-4 on the logits);
with bf16 activations an intermediate may round to the neighbouring bf16
value on one side (rtol = atol = 5e-2). The reference runs on its plain
XLA path (its default backend), as its own engine tests do. Chunked
prefill is held to those tolerances chunk for chunk, never bitwise: the
reference's own chunked-vs-whole-prompt test does not hold bitwise.

The host-side allocator and scheduler (``serve/blockpool``,
``serve/scheduler``, ``serve/prefixcache``) are driven through one seeded
sequence of operations on both packages and must give the same results.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro import models as RM
from repro import serve as RS
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.layers.attention import KVCache as RKVCache
from repro.train.servestep import _slot_admit as r_slot_admit
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.train.servestep import _slot_admit as t_slot_admit

TOL = {"f32": 1e-4, "bf16": 5e-2}
B, MAX_LEN, BS, PAD = 3, 16, 4, 8
PROMPTS = {0: 7, 1: 5}          # lane -> prompt length; lane 2 stays vacant


def _cfg(variant: str):
    base = RC.smoke(RC.get_config("qwen1.5-4b"))
    if variant == "bf16":
        base = dataclasses.replace(base, activation_dtype="bfloat16")
    return base, TC.ModelConfig(**dataclasses.asdict(base))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for variant in TOL:
        rcfg, tcfg = _cfg(variant)
        rparams = RM.init(jax.random.PRNGKey(3), rcfg)
        out[variant] = (rcfg, tcfg, rparams, interop.params_from_jax(
            jax.tree.map(np.asarray, rparams), tcfg, "cpu"))
    return out


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


def _blocks(lane: int) -> np.ndarray:
    """Lane ``lane``'s block-table row: distinct pool blocks, null-padded."""
    row = np.zeros(MAX_LEN // BS, np.int32)
    row[:3] = 1 + 3 * lane + np.arange(3)
    return row


def _admit(rcfg, tcfg, rp, tp, rstate, tstate, prompts, paged):
    """Prefill each lane's prompt on both sides (admit step, or 4-token
    chunks through the block table); returns the new reference state and
    the per-lane first logits of both sides, chunk by chunk."""
    seen = []
    for lane, prompt in prompts.items():
        if not paged:
            padded = np.zeros((1, PAD), np.int64)
            padded[0, :len(prompt)] = prompt
            rl, rstate = r_slot_admit(
                rp, rstate, jnp.asarray(padded, jnp.int32),
                jnp.asarray(lane, jnp.int32),
                jnp.asarray(len(prompt), jnp.int32), cfg=rcfg, mesh=None,
                prompt_pad=PAD)
            tl = t_slot_admit(tp, tstate, _i(padded), _i(lane),
                              _i(len(prompt)), cfg=tcfg, prompt_pad=PAD)
            seen.append((np.asarray(rl), tl.numpy()))
            continue
        start = 0
        while start < len(prompt):
            n = min(4, len(prompt) - start)
            chunk = np.zeros((1, 4), np.int64)
            chunk[0, :n] = prompt[start:start + n]
            rl, rstate = RM.prefill_chunk(
                rp, jnp.asarray(chunk, jnp.int32), rcfg, rstate,
                slot=jnp.asarray(lane, jnp.int32),
                start=jnp.asarray(start, jnp.int32),
                true_len=jnp.asarray(n, jnp.int32),
                blocks=jnp.asarray(_blocks(lane)))
            tl, _ = TM.prefill_chunk(tp, _i(chunk), tcfg, tstate,
                                     slot=_i(lane), start=_i(start),
                                     true_len=_i(n),
                                     blocks=_i(_blocks(lane)))
            seen.append((np.asarray(rl[0]), tl[0].numpy()))
            start += n
    return rstate, seen


@pytest.mark.parametrize("variant", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_per_slot_decode_matches_reference(weights, variant, layout):
    rcfg, tcfg, rp, tp = weights[variant]
    tol, paged = TOL[variant], layout == "paged"
    kw = dict(kv_block_size=BS, num_kv_blocks=13) if paged else {}
    rng = np.random.default_rng(11)
    prompts = {lane: rng.integers(0, rcfg.vocab_size, n)
               for lane, n in PROMPTS.items()}
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rstate = RM.init_decode_state(rcfg, B, MAX_LEN, per_slot=True, **kw)
        tstate = TM.init_decode_state(tcfg, B, MAX_LEN, per_slot=True,
                                      device="cpu", **kw)
        rstate, seen = _admit(rcfg, tcfg, rp, tp, rstate, tstate, prompts,
                              paged)
        for want, got in seen:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        active = np.array([1, 1, 0])
        last = {lane: seen[-1 if lane == 1 else (1 if paged else 0)][0]
                for lane in prompts}
        tok = np.array([np.argmax(last[0][:rcfg.vocab_size]),
                        np.argmax(last[1][:rcfg.vocab_size]), 0])
        for _ in range(4):
            rl, rstate = RM.decode_step(
                rp, jnp.asarray(tok[:, None], jnp.int32), rcfg, rstate,
                active=jnp.asarray(active, jnp.int32))
            tl, tstate = TM.decode_step(tp, _i(tok[:, None]), tcfg, tstate,
                                        active=_i(active))
            want = np.asarray(rl)
            np.testing.assert_allclose(tl.numpy()[:2], want[:2], rtol=tol,
                                       atol=tol)
            np.testing.assert_array_equal(tstate["kv"].length.numpy(),
                                          np.asarray(rstate["kv"].length))
            tok = np.where(active, want[:, :rcfg.vocab_size].argmax(-1), 0)
        assert tstate["kv"].length.dtype == torch.int32
        assert tstate["kv"].length.tolist() == [7 + 4, 5 + 4, 0]
        if paged:
            np.testing.assert_array_equal(tstate["kv"].table.numpy(),
                                          np.asarray(rstate["kv"].table))


def test_prefill_chunk_matches_reference_chunk_for_chunk(weights):
    """An 11-token prompt as chunks of 4, 4 and 3 (padded to 4) into lane 1
    of a paged state: every chunk's logits, the lengths and the table."""
    rcfg, tcfg, rp, tp = weights["f32"]
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab_size, 11)
    kw = dict(per_slot=True, kv_block_size=BS, num_kv_blocks=16)
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rstate = RM.init_decode_state(rcfg, 2, 24, **kw)
        tstate = TM.init_decode_state(tcfg, 2, 24, device="cpu", **kw)
        blocks = np.zeros(6, np.int32)
        blocks[:3] = [1, 2, 3]
        for start, n in ((0, 4), (4, 4), (8, 3)):
            chunk = np.zeros((1, 4), np.int64)
            chunk[0, :n] = prompt[start:start + n]
            rl, rstate = RM.prefill_chunk(
                rp, jnp.asarray(chunk, jnp.int32), rcfg, rstate,
                slot=jnp.asarray(1, jnp.int32),
                start=jnp.asarray(start, jnp.int32),
                true_len=jnp.asarray(n, jnp.int32),
                blocks=jnp.asarray(blocks))
            tl, tstate = TM.prefill_chunk(tp, _i(chunk), tcfg, tstate,
                                          slot=_i(1), start=_i(start),
                                          true_len=_i(n), blocks=_i(blocks))
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                       rtol=1e-4, atol=1e-4)
        assert tstate["kv"].length.tolist() == [0, 11]
        np.testing.assert_array_equal(tstate["kv"].table.numpy(),
                                      np.asarray(rstate["kv"].table))
        # the written blocks hold the reference's K/V (block 0 takes the
        # pad position's write on both sides and is never read validly)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tstate["kv"], name)[:, 1:4].numpy(),
                np.asarray(getattr(rstate["kv"], name))[:, 1:4],
                rtol=1e-4, atol=1e-4)


def test_paged_decode_bit_exact_vs_contiguous_per_slot(weights):
    """The same logical cache held contiguously and in pool blocks (block
    size dividing max_len, so both contract over the same key extent):
    every decode step's logits are equal bit for bit."""
    _, tcfg, _, tp = weights["f32"]
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 7)
    with t_use_context(plan_cache=TPlanCache()):
        cstate = TM.init_decode_state(tcfg, 2, MAX_LEN, per_slot=True,
                                      device="cpu")
        padded = np.zeros((1, PAD), np.int64)
        padded[0, :7] = prompt
        first = t_slot_admit(tp, cstate, _i(padded), _i(0), _i(7), cfg=tcfg,
                             prompt_pad=PAD)
        pstate = TM.init_decode_state(tcfg, 2, MAX_LEN, per_slot=True,
                                      kv_block_size=BS, num_kv_blocks=8,
                                      device="cpu")
        ckv, pkv = cstate["kv"], pstate["kv"]
        pkv.table[0] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
        for j in range(4):
            pkv.k[:, j + 1] = ckv.k[:, 0, j * BS:(j + 1) * BS]
            pkv.v[:, j + 1] = ckv.v[:, 0, j * BS:(j + 1) * BS]
        pkv.length.copy_(ckv.length)
        active = _i([1, 0])
        tok = int(first[:tcfg.vocab_size].argmax())
        for _ in range(5):
            feed = _i([[tok], [0]])
            lc, _ = TM.decode_step(tp, feed, tcfg, cstate, active=active)
            lp, _ = TM.decode_step(tp, feed, tcfg, pstate, active=active)
            assert torch.equal(lc[0], lp[0])
            assert pkv.length.tolist() == ckv.length.tolist()
            tok = int(lp[0, :tcfg.vocab_size].argmax())
        assert pkv.length.tolist() == [12, 0]


def test_vacant_lane_at_max_len_neither_raises_nor_writes(weights):
    """A vacant lane whose length sits at max_len: the reference's scatter
    drops the write (``mode="drop"``); the port's clamps the index and
    writes the old value back. The live lane matches the reference."""
    rcfg, tcfg, rp, tp = weights["f32"]
    rng = np.random.default_rng(2)
    shape = (rcfg.n_layers, 2, 8, rcfg.n_kv_heads, rcfg.head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    length = np.array([3, 8], np.int32)
    tok = np.array([[5], [0]])
    active = np.array([1, 0])
    with t_use_context(plan_cache=TPlanCache()):
        tstate = TM.init_decode_state(tcfg, 2, 8, per_slot=True,
                                      device="cpu")
        kv = tstate["kv"]
        kv.k.copy_(torch.from_numpy(k0))
        kv.v.copy_(torch.from_numpy(v0))
        kv.length.copy_(torch.from_numpy(length))
        tl, _ = TM.decode_step(tp, _i(tok), tcfg, tstate, active=_i(active))
    assert torch.equal(kv.k[:, 1], torch.from_numpy(k0[:, 1]))
    assert torch.equal(kv.v[:, 1], torch.from_numpy(v0[:, 1]))
    assert kv.length.tolist() == [4, 8]
    # lane 0 wrote position 3 and nothing else
    changed = (kv.k[:, 0] != torch.from_numpy(k0[:, 0])).any(-1).any(-1)
    assert changed.any(0).nonzero().flatten().tolist() == [3]
    rstate = {"kv": RKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                             length=jnp.asarray(length))}
    with r_use_context(plan_cache=RPlanCache()):
        rl, rstate = RM.decode_step(rp, jnp.asarray(tok, jnp.int32), rcfg,
                                    rstate, active=jnp.asarray(active))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(rl)[0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(rstate["kv"].k),
                               rtol=1e-4, atol=1e-4)


def _pool_ops(pkg) -> list:
    """A seeded sequence of alloc / incref / decref / cached-idle moves on
    a ref-counted pool, with every result and the stats after each op."""
    rng = np.random.default_rng(4)
    pool = pkg.BlockPool(16, 4, bytes_per_block=64)
    held: list[list[int]] = []
    out = []
    for _ in range(80):
        op = rng.integers(0, 4)
        if op == 0 or not held:
            got = pool.alloc(int(rng.integers(1, 5)))
            if got is not None:
                held.append(got)
            out.append(("alloc", got))
        elif op == 1:
            blocks = held[int(rng.integers(0, len(held)))]
            pool.incref(blocks)
            held.append(list(blocks))
            out.append(("incref", blocks))
        elif op == 2:
            blocks = held.pop(int(rng.integers(0, len(held))))
            pool.decref(blocks)
            out.append(("decref", blocks))
        else:
            blocks = held[int(rng.integers(0, len(held)))]
            out.append(("frag", pool.fragmentation_tokens(
                4 * len(blocks) - 1)))
        out.append(pool.stats())
    return out


def _sched_ops(pkg) -> list:
    """A seeded request stream through a 3-lane scheduler with a paged pool,
    the prefix cache and the preemptive priority policy: submissions (half
    share a header), admissions, chunked prefill, decode tokens and
    evictions; every outcome and the counters after each op."""
    rng = np.random.default_rng(5)
    pool = pkg.BlockPool(20, 4)
    sched = pkg.SlotScheduler(3, max_len=32, pool=pool,
                              prefix_cache=pkg.PrefixCache(pool),
                              policy="priority")
    header = rng.integers(0, 40, 8)
    index: dict[int, int] = {}
    out = []
    for step in range(120):
        now = 0.01 * step
        op = rng.integers(0, 4)
        if op == 0:
            tail = rng.integers(0, 40, int(rng.integers(1, 6)))
            prompt = np.concatenate([header, tail]) if rng.random() < 0.5 \
                else tail
            r = pkg.Request(prompt=prompt,
                            max_new_tokens=int(rng.integers(1, 6)),
                            priority=int(rng.integers(0, 3)))
            index[r.request_id] = len(index)
            sched.submit(r, now)
            out.append(("submit", index[r.request_id]))
        elif op == 1:
            st = sched.admit_next(now)
            out.append(("admit", None if st is None else (
                index[st.request.request_id], st.slot, st.cached_tokens,
                list(st.blocks), st.prefill_done)))
        elif op == 2:
            st = sched.prefill_head()
            if st is not None:
                n = min(4, st._target - st.prefill_done)
                sched.prefill_advance(st.slot, n)
                out.append(("chunk", st.slot, n))
        else:
            for slot in np.flatnonzero(sched.decode_mask()):
                st = sched.slots[slot]
                st.append(int(rng.integers(0, 40)), now, tick=sched.tick)
                if len(st.tokens) >= st.request.budget(sched.max_len):
                    sched.evict(slot, "length", now)
                    out.append(("evict", index[st.request.request_id]))
        sched.tick += 1
        out.append((sched.counters(), pool.stats(), sched.live_tokens(),
                    sched.decode_mask().tolist()))
    out.append([(index[s.request.request_id], s.finish_reason,
                 s.preemptions, s.tokens) for s in sched.finished])
    return out


@pytest.mark.parametrize("ops", [_pool_ops, _sched_ops])
def test_blockpool_and_scheduler_give_the_reference_results(ops):
    want, got = ops(RS), ops(TS)
    assert len(got) == len(want) > 100
    assert got == want
