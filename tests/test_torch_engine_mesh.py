"""The port's serving engines over a mesh on the CPU, against the
reference's engine at 1 x 1 under ``SimClock``.

A module fixture runs the reference's ``ServeEngine`` on one device for
two smoke configs (qwen1.5-4b: 4 kv heads; internlm2-20b: 2 kv heads) in
four modes, writes their weights (the port's tree) and its records to
disk, and spawns jobs of ranks that import no JAX (``torch.distributed``
over loopback, torchrun's environment):

* 8 ranks: every mode of both configs over 4 x 2, 2 x 4 and 1 x 8 (data,
  model) meshes: the admission sequence, the aggregate counters, the
  tokens, the speculation section, each rank's local state shapes, each
  step's collective bytes and the clock's; then the reference's paged state
  after three chunked prefills, handed to the 2 x 4 mesh by
  ``interop.shard_state``, and one tick from it;
* 1 rank: every mode on a 1 x 1 mesh and on no mesh (the one-device
  engine), with every committed token's logit margin and each request's
  first-token logits;
* 2 ranks (2 x 1) with rank 1's clock skewed: the prefix-cache mode's
  schedule; and the int8 pool over 'data' against the one-device engine.

The modes (``MODES``), and how each lies over DP (D = the DP extent):

* ``contiguous``: 2 lanes, max_len 16. D = 4: the sequence over DP; D = 2:
  the lanes;
* ``paged_prefix`` (the prefix cache, the TTFT budget): 2 lanes, 14 pool
  blocks. D = 4: blocks and lanes replicated; D = 2: both split;
* ``paged_preemptive`` (the priority policy): 1 lane, 16 blocks. D = 4 and
  2: the blocks split, the lane replicated;
* ``spec`` (a float draft, the target's config from another seed, k = 2):
  4 lanes, 18 blocks. D = 4: the blocks replicated, the lanes split; D = 2:
  both split.

internlm2's 2 kv heads on a 'model' axis of 4 or 8, and qwen's 4 on 8,
take the head_dim layout; the rest the kv-heads layout.

Stated beforehand: the admission and eviction sequence, the aggregate
counters and the speculation section equal the reference's; the tokens
equal up to each request's first near-tie in the reference (its top-2
margin within 1e-4 of 1 + |top|, ``tests/test_torch_engine.py``'s rule;
the speculative mode commits the target's argmaxes, compared whole as in
``tests/test_torch_spec.py``); every rank equal to every other; each
step's collective bytes equal to the dry run's cell
(``launch.dryrun.engine_cells``); the 1 x 1 mesh engine equal to the
one-device engine bit for bit (logits, tokens, dispatches); the handed
state's tick within 1e-4 of 1 + |logit| of the reference's.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import models as RM
from repro import serve as RS
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch.mesh import make_local_mesh as r_make_local_mesh
from repro_torch import configs as C
from repro_torch import interop
from repro_torch import models
from repro_torch import serve as TS
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, free_port
from repro_torch.layers import attention as attn
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardPlan
from repro_torch.quant.prequant import quantize_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen1.5-4b", "internlm2-20b")
SEED, DRAFT_SEED, SPEC_K = 3, 4, 2
TOL = 1e-4
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}
MODE_NAMES = ("contiguous", "paged_prefix", "paged_preemptive", "spec")
TIMEOUT = 600  # seconds, for each job (8 ranks beside the other workers)
# the shard_state check: 4 lanes over a pool of 16 blocks of 4
HAND = dict(lanes=4, max_len=24, bs=4, blocks=16, prompts=(7, 5, 9))

MODES_SRC = r'''
def mode_kw(pkg, name, vocab, draft=None):
    """(engine keyword arguments, trace) of one mode from ``pkg``'s trace
    generators (the same seeds in both packages)."""
    if name == "contiguous":
        return (dict(num_slots=2, max_len=16, prompt_pad=8,
                     clock=pkg.SimClock(1e-3)),
                pkg.synthetic_trace(5, vocab_size=vocab,
                                    prompt_lens=[8, 4, 6],
                                    max_new_tokens=[4, 2, 3], seed=7))
    if name == "paged_prefix":
        return (dict(num_slots=2, max_len=20, prompt_pad=8, kv_block_size=4,
                     num_kv_blocks=14, prefill_chunk=4, prefix_cache=True,
                     ttft_target_ms=5.0, max_prefill_chunks=2,
                     clock=pkg.SimClock(1e-3)),
                pkg.shared_prefix_trace(6, vocab_size=vocab, header_len=8,
                                        tail_lens=[1, 3],
                                        max_new_tokens=[5, 3], seed=1))
    if name == "spec":
        cfg, params = draft
        return (dict(num_slots=4, max_len=24, prompt_pad=8, kv_block_size=4,
                     num_kv_blocks=18, prefill_chunk=4,
                     clock=pkg.SimClock(1e-3), spec_draft_cfg=cfg,
                     spec_draft_params=params, spec_k=SPEC_K),
                pkg.synthetic_trace(5, vocab_size=vocab, prompt_lens=[8, 5],
                                    max_new_tokens=[5, 3], seed=2))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, size=6) for _ in range(3)]
    return (dict(num_slots=1, max_len=24, prompt_pad=8, kv_block_size=4,
                 num_kv_blocks=16, sched_policy="priority",
                 clock=pkg.SimClock(1e-4)),
            [pkg.Request(prompt=prompts[0], max_new_tokens=10, priority=0),
             pkg.Request(prompt=prompts[1], max_new_tokens=3, priority=5,
                         arrival_s=0.002),
             pkg.Request(prompt=prompts[2], max_new_tokens=4, priority=2,
                         arrival_s=0.003)])


def outcome(engine, trace, m):
    """The admission sequence, tokens and aggregate counters by trace
    index (request ids differ from run to run)."""
    ids = {r.request_id: i for i, r in enumerate(trace)}
    seq = [[ids[st.request.request_id], st.slot, st.admitted_tick,
            st.first_token_tick, st.finished_tick, st.finish_reason,
            st.preemptions, st.cached_tokens] for st in engine.finished]
    toks = {ids[st.request.request_id]: list(st.tokens)
            for st in engine.finished}
    spec = {k: v for k, v in m.speculation.items()
            if k not in ("draft_s", "verify_s")}
    return seq, toks, m.to_dict()["aggregate"], spec
'''

PROG = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs as C
from repro_torch import interop, models
from repro_torch import serve as TS
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items, tree_map
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.layers.attention import PagedKVCache
from repro_torch.train.servestep import make_paged_engine_step

mode, work = sys.argv[1], sys.argv[2]
ARCHS, SPEC_K, MESHES, MODE_NAMES, HAND = {consts}
{modes}


def weights(arch, tag):
    cfg = C.smoke(C.get_config(arch))
    z = np.load(os.path.join(work, f"{{arch}}_{{tag}}.npz"))
    shapes = models.init(cfg, device="meta")
    it = iter([torch.from_numpy(z[p].copy()) for p, _ in tree_items(shapes)])
    return cfg, tree_map(lambda _: next(it), shapes)


def run(cfg, params, draft, name, mesh, clock=None, log=False, **kw):
    ekw, trace = mode_kw(TS, name, cfg.vocab_size, draft)
    if clock is not None:
        ekw["clock"] = clock
    ekw.update(kw)
    with use_context(plan_cache=PlanCache()):
        engine = TS.ServeEngine(cfg, params, mesh=mesh, **ekw)
        if log:
            engine.token_log = []
        engine.plan_warmup()
        m = engine.run(trace)
    seq, toks, agg, spec = outcome(engine, trace, m)
    return engine, {{
        "seq": seq, "tokens": toks, "agg": agg, "spec": spec,
        "shapes": {{p: list(t.shape) for p, t in tree_items(engine.state)}},
        "draft_shapes": {{p: list(t.shape) for p, t in
                         tree_items(engine.draft_state or {{}})}},
        "bytes": {{k: sorted(set(v)) for k, v in engine.step_bytes.items()}},
        "clock": engine.clock_bytes.by_kind(),
        "dispatches": dict(engine.dispatches)}}


def hand(mesh, cfg, params):
    # the reference's paged state after three prefills, laid out for this
    # rank by shard_state, and one tick from it
    z = np.load(os.path.join(work, "hand.npz"))
    kv = PagedKVCache(*(torch.from_numpy(z["state/" + f].copy())
                        for f in ("k", "v", "table", "length")))
    state = interop.shard_state({{"kv": kv}}, None, mesh, cfg=cfg)
    art = make_paged_engine_step(
        cfg, num_slots=HAND["lanes"], max_len=HAND["max_len"],
        kv_block_size=HAND["bs"], num_kv_blocks=HAND["blocks"],
        chunk_buckets=(4,), device="cpu", mesh=mesh)
    blocks = art.layout.shard_params(params)
    logits = art.decode_fn(blocks, state, z["tokens"], z["active"])
    want = torch.from_numpy(z["logits"])
    return {{"err": float(((logits - want).abs() / (1 + want.abs())).max()),
            "shapes": {{p: list(t.shape) for p, t in tree_items(state)}},
            "length": state["kv"].length.tolist()}}


res = {{}}
models_ = {{a: (weights(a, "target"), weights(a, "draft")) for a in ARCHS}}
if mode == "mesh8":
    for mname, shape in MESHES.items():
        mesh = make_local_mesh(*shape, device="cpu")
        for arch in ARCHS:
            (cfg, params), draft = models_[arch]
            for name in MODE_NAMES:
                res[f"{{mname}}/{{arch}}/{{name}}"] = run(
                    cfg, params, draft, name, mesh)[1]
        if mname == "2x4":
            (cfg, params), _ = models_["qwen1.5-4b"]
            res["hand"] = hand(mesh, cfg, params)
elif mode == "mesh1":
    mesh = make_local_mesh(1, 1, device="cpu")
    for arch in ARCHS:
        (cfg, params), draft = models_[arch]
        for name in MODE_NAMES:
            got = [run(cfg, params, draft, name, m_, log=True)
                   for m_ in (mesh, None)]
            # request ids differ from run to run: by commit order
            logs = [[t[1:] for t in e.token_log] for e, _ in got]
            first = [[e.first_logits[k] for k in sorted(e.first_logits)]
                     for e, _ in got]
            res[f"{{arch}}/{{name}}"] = {{
                "same_log": logs[0] == logs[1],
                "same_first": len(first[0]) == len(first[1]) and all(
                    np.array_equal(a, b) for a, b in zip(*first)),
                "logged": len(got[0][0].token_log),
                "mesh": got[0][1], "plain": got[1][1]}}
else:  # skew: 2 x 1, rank 1's clock 100 s ahead and twice as fast
    mesh = make_local_mesh(2, 1, device="cpu")
    (cfg, params), draft = models_["qwen1.5-4b"]
    clock = (TS.SimClock(1e-3) if mesh.rank == 0
             else TS.SimClock(2e-3, start=100.0))
    res["skew"] = run(cfg, params, draft, "paged_prefix", mesh,
                      clock=clock)[1]
    res["int8"] = [run(cfg, params, draft, "paged_prefix", m_,
                       kv_quantize="int8")[1] for m_ in (mesh, None)]
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
rank = dist.get_rank()
with open(os.path.join(work, f"{{mode}}_rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''

exec(MODES_SRC)



def _spawn(prog_path: str, mode: str, n: int, work: str) -> list:
    port, procs = free_port(), []
    for rank in range(n):
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "RANK": str(rank), "WORLD_SIZE": str(n),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, prog_path, mode, work], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, timeout: float) -> None:
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _record_samples(engine, vocab: int) -> list:
    """(request id, token, top-2 margin, top-1 value) of every sampled
    token, in order (``tests/test_torch_engine.py``'s)."""
    log = []
    sample = engine._sample

    def recorded(row, st):
        tok = sample(row, st)
        top = np.sort(np.asarray(row[:vocab], np.float64))[-2:]
        log.append((st.request.request_id, tok, top[1] - top[0], top[1]))
        return tok

    engine._sample = recorded
    return log


def _reference(arch: str, work: str) -> dict:
    """The reference's engine at 1 x 1 in every mode: its outcome and the
    sure prefix of each request's tokens; its weights (target and draft)
    written as the port's trees."""
    rcfg, cfg = RC.smoke(RC.get_config(arch)), C.smoke(C.get_config(arch))
    rp = RM.init(jax.random.PRNGKey(SEED), rcfg)
    rd = RM.init(jax.random.PRNGKey(DRAFT_SEED), rcfg)
    for tag, tree in (("target", rp), ("draft", rd)):
        port = interop.params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                       "cpu")
        np.savez(os.path.join(work, f"{arch}_{tag}.npz"),
                 **{p: t.numpy() for p, t in tree_items(port)})
    out = {}
    for name in MODE_NAMES:
        kw, trace = mode_kw(RS, name, rcfg.vocab_size, (rcfg, rd))
        with r_use_context(plan_cache=RPlanCache()):
            engine = RS.ServeEngine(rcfg, r_make_local_mesh(), rp, **kw)
            log = _record_samples(engine, rcfg.vocab_size)
            engine.plan_warmup()
            m = engine.run(trace)
        seq, toks, agg, spec = outcome(engine, trace, m)
        ids = {r.request_id: i for i, r in enumerate(trace)}
        sure = {}
        for rid, _, margin, top in log:
            sure.setdefault(ids[rid], []).append(margin > TOL * (1 + abs(top)))
        # how many of each request's tokens precede its first near-tie
        upto = {i: len(t) if name == "spec" or all(sure.get(i, []))
                else sure[i].index(False) for i, t in toks.items()}
        out[name] = {"seq": seq, "tokens": toks, "agg": agg, "spec": spec,
                     "upto": upto}
    return out


def _hand_state(work: str) -> None:
    """The reference's paged state after three chunked prefills (lanes 0-2)
    and the logits of one tick from it, for ``shard_state``."""
    arch = "qwen1.5-4b"
    rcfg = RC.smoke(RC.get_config(arch))
    rp = RM.init(jax.random.PRNGKey(SEED), rcfg)
    lanes, bs = HAND["lanes"], HAND["bs"]
    state = RM.init_decode_state(rcfg, lanes, HAND["max_len"], per_slot=True,
                                 kv_block_size=bs,
                                 num_kv_blocks=HAND["blocks"])
    rng = np.random.default_rng(5)
    mb = state["kv"].table.shape[1]
    last = []
    nxt = 1
    for lane, n in enumerate(HAND["prompts"]):
        blocks = np.zeros((mb,), np.int32)
        need = -(-(n + 1) // bs)
        blocks[:need] = np.arange(nxt, nxt + need)
        nxt += need
        prompt = rng.integers(0, rcfg.vocab_size, (1, n)).astype(np.int32)
        pad = -(-n // bs) * bs
        for start in range(0, n, bs):
            m = min(bs, n - start)
            chunk = np.zeros((1, bs), np.int32)
            chunk[0, :m] = prompt[0, start:start + m]
            logits, state = RM.prefill_chunk(
                rp, jnp.asarray(chunk), rcfg, state, slot=jnp.int32(lane),
                start=jnp.int32(start), true_len=jnp.int32(m),
                blocks=jnp.asarray(blocks))
        assert pad >= n
        last.append(int(np.argmax(np.asarray(logits)[0, :rcfg.vocab_size])))
    tokens = np.array(last + [0], np.int64)[:, None]
    active = np.array([1, 1, 1, 0], np.int64)
    kv = state["kv"]
    saved = {"state/" + f: np.asarray(getattr(kv, f))
             for f in ("k", "v", "table", "length")}
    logits, _ = RM.decode_step(rp, jnp.asarray(tokens, jnp.int32), rcfg,
                               state, active=jnp.asarray(active, jnp.int32))
    np.savez(os.path.join(work, "hand.npz"), tokens=tokens, active=active,
             logits=np.asarray(logits, np.float32), **saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("engine_mesh"))
    with r_use_context(plan_cache=RPlanCache()):
        ref = {a: _reference(a, work) for a in ARCHS}
        _hand_state(work)
    prog = os.path.join(work, "rank.py")
    with open(prog, "w") as f:
        f.write(PROG.format(consts=(ARCHS, SPEC_K, MESHES, MODE_NAMES, HAND),
                            modes=MODES_SRC))
    jobs = [_spawn(prog, "mesh8", 8, work)]
    _wait(jobs.pop(), TIMEOUT)
    later = _spawn(prog, "mesh1", 1, work) + _spawn(prog, "skew", 2, work)
    _wait(later, TIMEOUT)
    load = lambda name: json.load(open(os.path.join(work, name + ".json")))
    # JSON's string keys on both sides
    return {"ref": json.loads(json.dumps(ref)),
            "mesh8": [load(f"mesh8_rank{r}") for r in range(8)],
            "mesh1": load("mesh1_rank0"),
            "skew": [load(f"skew_rank{r}") for r in range(2)]}


CASES = [(m, a, n) for m in MESHES for a in ARCHS for n in MODE_NAMES]


def _key(mesh, arch, name):
    return f"{mesh}/{arch}/{name}"


def _tokens_match(got: dict, want: dict) -> int:
    """Tokens equal up to each request's first near-tie in the reference;
    returns how many were compared."""
    compared = 0
    for i, toks in want["tokens"].items():
        n = want["upto"][i]
        assert got["tokens"][i][:n] == toks[:n], (i, got["tokens"][i], toks)
        compared += n
    return compared


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for r in runs["mesh8"] + runs["skew"])
    assert not runs["mesh1"]["jax_imported"]


@pytest.mark.parametrize("mesh,arch,name", CASES)
def test_engine_over_mesh_matches_reference(runs, mesh, arch, name):
    want = runs["ref"][arch][name]
    got = runs["mesh8"][0][_key(mesh, arch, name)]
    assert got["seq"] == want["seq"]          # admission / eviction sequence
    assert got["agg"] == want["agg"]          # aggregate counters and rates
    assert got["spec"] == want["spec"]        # acceptance, rounds, bonus
    compared = _tokens_match(got, want)
    assert compared >= 0.9 * sum(len(t) for t in want["tokens"].values())
    if name == "paged_preemptive":
        assert got["agg"]["preemptions"] >= 1
    if name == "paged_prefix":
        assert got["agg"]["generated_tokens"] > 0


@pytest.mark.parametrize("mesh,arch,name", CASES)
def test_every_rank_runs_the_same_schedule(runs, mesh, arch, name):
    first = runs["mesh8"][0][_key(mesh, arch, name)]
    for rec in runs["mesh8"][1:]:
        other = rec[_key(mesh, arch, name)]
        for k in ("seq", "tokens", "agg", "spec", "dispatches", "bytes",
                  "clock"):
            assert other[k] == first[k], k


def _state_specs(arch, name, shape):
    """The engine state's (and the draft's) whole shapes and specs."""
    cfg = C.smoke(C.get_config(arch))
    kw, _ = mode_kw(TS, name, cfg.vocab_size, (cfg, None))
    paged = "kv_block_size" in kw
    mesh = Mesh(("data", "model"), shape)
    out = []
    whole = models.init_decode_state(
        cfg, kw["num_slots"], kw["max_len"], per_slot=True,
        kv_block_size=kw.get("kv_block_size"),
        num_kv_blocks=kw.get("num_kv_blocks"), device="meta")
    out.append((whole, shd.decode_state_specs(whole, cfg, mesh, paged=paged)))
    if name == "spec":
        draft = models.init_decode_state(cfg, kw["num_slots"], kw["max_len"],
                                         per_slot=True, device="meta")
        out.append((draft, shd.decode_state_specs(draft, cfg, mesh)))
    return mesh, out


@pytest.mark.parametrize("mesh,arch,name", CASES)
def test_local_state_is_its_specs_blocks(runs, mesh, arch, name):
    m, states = _state_specs(arch, name, MESHES[mesh])
    for r, rec in enumerate(runs["mesh8"]):
        got = rec[_key(mesh, arch, name)]
        for (whole, specs), have in zip(states, ("shapes", "draft_shapes")):
            spec_of = dict(tree_items(specs))
            want = {p: list(shd.local_shape(tuple(t.shape), spec_of[p], m))
                    for p, t in tree_items(whole)}
            assert got[have] == want, (r, have)


def test_blocks_and_lanes_lie_split_and_replicated(runs):
    """The four combinations of a pool's block axis and the lanes over DP
    each occur (named in the module docstring)."""
    seen = set()
    for mesh, shape in MESHES.items():
        for name in ("paged_prefix", "paged_preemptive", "spec"):
            cfg = C.smoke(C.get_config("qwen1.5-4b"))
            kw, _ = mode_kw(TS, name, cfg.vocab_size, (cfg, None))
            got = runs["mesh8"][0][_key(mesh, "qwen1.5-4b", name)]
            d = shape[0]
            if d == 1:
                continue
            blocks = got["shapes"]["kv/k"][1] != kw["num_kv_blocks"]
            assert blocks == (kw["num_kv_blocks"] % d == 0)
            seen.add((blocks, kw["num_slots"] % d == 0))
    assert seen == {(True, True), (True, False), (False, True),
                    (False, False)}


_CELLS = {}


def _cells(arch, name, shape):
    key = (arch, name, shape)
    if key not in _CELLS:
        cfg = C.smoke(C.get_config(arch))
        kw, _ = mode_kw(TS, name, cfg.vocab_size, (cfg, None))
        with use_context(plan_cache=PlanCache()):
            _CELLS[key] = dryrun.engine_cells(
                cfg, Mesh(("data", "model"), shape),
                num_slots=kw["num_slots"], max_len=kw["max_len"],
                prompt_pad=kw["prompt_pad"],
                kv_block_size=kw.get("kv_block_size"),
                num_kv_blocks=kw.get("num_kv_blocks"),
                prefill_chunk=kw.get("prefill_chunk"),
                draft_cfg=cfg if name == "spec" else None, spec_k=SPEC_K)
    return _CELLS[key]


@pytest.mark.parametrize("mesh,arch,name", CASES)
def test_step_collective_bytes_equal_dryrun(runs, mesh, arch, name):
    cells = _cells(arch, name, MESHES[mesh])
    got = runs["mesh8"][0][_key(mesh, arch, name)]
    assert got["bytes"] and set(got["bytes"]) <= set(cells)
    for tag, seen in got["bytes"].items():
        assert seen == [cells[tag]["collective_bytes_per_device"]], tag
    # the clock's broadcasts are counted apart from the steps'
    assert set(got["clock"]) == {"clock"} and got["clock"]["clock"] > 0
    assert all("clock" not in c["by_collective"] for c in cells.values())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", MODE_NAMES)
def test_one_by_one_mesh_is_the_one_device_engine(runs, arch, name):
    rec = runs["mesh1"][f"{arch}/{name}"]
    assert rec["same_log"] and rec["same_first"] and rec["logged"] > 0
    mesh, plain = rec["mesh"], rec["plain"]
    for k in ("seq", "tokens", "agg", "spec", "dispatches"):
        assert mesh[k] == plain[k], k
    assert mesh["bytes"] == {k: [0] for k in mesh["dispatches"]}
    assert mesh["clock"] == {}


def test_skewed_clock_keeps_one_schedule(runs):
    """Rank 1 reads a clock 100 s ahead and twice as fast; both ranks run
    rank 0's schedule, the reference's."""
    want = runs["ref"]["qwen1.5-4b"]["paged_prefix"]
    for rec in runs["skew"]:
        got = rec["skew"]
        assert got["seq"] == want["seq"] and got["agg"] == want["agg"]
        _tokens_match(got, want)
        assert got["clock"]["clock"] > 0


def test_int8_pool_over_data_is_the_one_device_pool(runs):
    for rec in runs["skew"]:
        mesh, plain = rec["int8"]
        assert mesh["shapes"]["kv/k"][1] == plain["shapes"]["kv/k"][1] // 2
        for k in ("seq", "tokens", "agg"):
            assert mesh[k] == plain[k], k


def test_shard_state_hands_the_paged_state_over(runs):
    """The reference's paged state laid out for 2 x 4 by
    ``interop.shard_state`` (its paged rules: the blocks over 'data', the
    kv heads over 'model', the table and lengths whole), and one tick."""
    for rec in runs["mesh8"]:
        h = rec["hand"]
        assert h["err"] <= TOL, h["err"]
        assert h["shapes"]["kv/k"] == [2, HAND["blocks"] // 2, HAND["bs"],
                                       1, 16]
        assert h["shapes"]["kv/table"] == [HAND["lanes"], 6]
        # the tick advanced the three live lanes
        assert h["length"] == [n + 1 for n in HAND["prompts"]] + [0]


def test_launcher_engine_over_a_mesh(tmp_path):
    """``torchrun ... launch.serve --engine --mesh 1x2 --device cpu``: both
    ranks finish every request with equal tokens and zero lazy solves."""
    prefix = str(tmp_path / "e")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(free_port()), "-m", "repro_torch.launch.serve", "--engine",
         "--kv-block-size", "4", "--mesh", "1x2", "--smoke", "--device",
         "cpu", "--plan-cache", "", "--record-out", prefix],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[mesh] 1x2" in run.stdout and "lazy_solves=0" in run.stdout
    recs = [torch.load(f"{prefix}.rank{r}.pt", weights_only=False)
            for r in range(2)]
    assert recs[0]["tokens"] == recs[1]["tokens"] and len(
        recs[0]["tokens"]) == 8
    assert recs[0]["admissions"] == recs[1]["admissions"]
    assert recs[0]["lazy_solves"] == 0 and recs[0]["step_bytes"]["decode"]


def test_engine_refusals_name_their_roadmap_items():
    abstract = Mesh(("data", "model"), (1, 2))
    # rwkv serves over 'model' (item 2, no longer refused): its static
    # decode step on the abstract mesh is tensor-parallel, one all-reduce
    # of the (B, 1, d) f32 partials for the time-mix's wo and one for the
    # channel-mix's wv a layer, and the vocab-parallel lookup's; int8
    # over a mesh runs too (item 11, no longer refused): the dynamic W8A8
    # step moves the float step's bytes and its scales' MAX reductions;
    # its engine is refused (the engines serve the KV-cache families)
    rwkv = C.smoke(C.get_config("rwkv6-3b"))
    with use_context(plan_cache=PlanCache()):
        dec = dryrun.serve_cell(rwkv, abstract, "decode", 2, 8)
    assert dec["cost"]["by_collective"]["all_reduce"] == \
        (2 * rwkv.n_layers + 1) * 2 * rwkv.d_model * 4
    with use_context(plan_cache=PlanCache(), quant_mode="int8"):
        q = dryrun.serve_cell(rwkv, abstract, "decode", 2, 8)
    q = dict(q["cost"]["by_collective"])
    assert q.pop("scale_max") > 0 and q == dec["cost"]["by_collective"]
    with pytest.raises(ValueError, match="KV-cache family"):
        TS.ServeEngine(rwkv, models.init(rwkv, device="meta"), num_slots=2,
                       max_len=16, prompt_pad=8, mesh=abstract)
    # the moe engine runs over a mesh (expert parallelism): its steps on
    # the abstract mesh count all-to-alls over 'data'
    moe = C.smoke(C.get_config("olmoe-1b-7b"))
    with use_context(plan_cache=PlanCache()):
        cells = dryrun.engine_cells(
            moe, Mesh(("data", "model"), (2, 2)), num_slots=2, max_len=16,
            prompt_pad=8, kv_block_size=4, prefill_chunk=4)
    assert cells["decode"]["by_collective"]["all_to_all"] > 0
    # int8 weights and the int8 pool run over 'model' (items 3 and 9, no
    # longer refused): the paged tick on the abstract mesh counts the
    # W8A8 scales' MAX reductions beside the float tick's collectives, and
    # the pool lies by its kv heads (qwen-smoke's 4 over 'model' = 2, the
    # scales split with them) or its head_dim (over 8, the scales whole),
    # or whole where 'model' divides neither (over 3: item 10, no longer
    # refused; every weight whole too at this width, so no scale spans
    # 'model')
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    for shape, layout, hkv in (((1, 2), "heads", 2), ((1, 8), "head_dim",
                                                      4), ((1, 3), "whole",
                                                           4)):
        mesh = Mesh(("data", "model"), shape)
        got = {q: _paged_tick(cfg, mesh, q) for q in (False, True)}
        assert got[True][1] == [hkv] * 2
        assert (got[True][0].pop("scale_max", 0) > 0) == (layout != "whole")
        assert got[True][0] == got[False][0]
        specs = shd.param_specs(models.axes(cfg), models.init(
            cfg, device="meta"), mesh)
        pool = models.init_decode_state(
            cfg, 2, 16, per_slot=True, kv_block_size=4, num_kv_blocks=9,
            kv_dtype="int8", device="meta")["kv"]
        with use_context(mesh=mesh, shard=ShardPlan(mesh, specs)):
            assert attn._pool_layout(pool, cfg.n_kv_heads,
                                     cfg.head_dim) == layout


def _paged_tick(cfg, mesh, int8: bool) -> tuple[dict, list]:
    """One paged tick of 2 lanes on an abstract mesh, float or with int8
    weights (pre-quantized) and the int8 pool: (its collective bytes by
    kind, the local scales' trailing dims)."""
    from repro_torch.core.distributed import CollectiveCounter
    from repro_torch.train.servestep import make_paged_engine_step

    with use_context(plan_cache=PlanCache()):
        art = make_paged_engine_step(
            cfg, max_len=16, kv_block_size=4, num_kv_blocks=9,
            chunk_buckets=(4,), device="meta", num_slots=2, mesh=mesh,
            quantized=int8, kv_dtype="int8" if int8 else None)
        params = models.init(cfg, device="meta")
        params = art.layout.shard_params(
            quantize_params(params) if int8 else params)
        state = art.init_state("meta")
        tokens = torch.zeros((2, 1), dtype=torch.int64, device="meta")
        with CollectiveCounter() as c:
            art.decode_raw(params, state, tokens,
                           torch.ones(2, dtype=torch.int64, device="meta"))
    scales = [] if not int8 else [state["kv"].k_scale.shape[-1],
                                  state["kv"].v_scale.shape[-1]]
    return c.by_kind(), scales
