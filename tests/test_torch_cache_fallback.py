"""KV caches over a 'model' extent that divides neither the kv heads nor
head_dim, on the CPU, against the reference over the same mesh.

The reference lays such a contiguous cache's sequence over 'model' where
'model' divides it (``decode_state_specs``: kv heads, then head_dim, then
the sequence) and keeps it whole elsewhere; a pool never takes the
sequence fallback and stays whole over 'model'. GSPMD lowers its decode
over a sequence-split cache to partial softmaxes combined over 'model'.
The port writes the positions a rank holds and attends over them: each
rank's f32 max and sum of exponentials all-gathered over 'model', its
probabilities normalized by the global ones (as one device's softmax
normalizes them) and its weighted V summed over 'model'
(``layers.attention._softmax_over_model``); a whole cache or pool is
written and read whole on every rank.

This process draws the prompts and the encoder frames (numpy, seed
``SEED``) and the reference's init of each smoke model (``PRNGKey(SEED)``,
the draft's ``PRNGKey(DRAFT_SEED)``), writes the port's trees to an .npz,
then runs at once the reference in a subprocess (6 of 8 host devices) and
6 gloo ranks, whose ranks import no JAX, over (2, 3) and (1, 6) meshes:

* the static server (4 rows, 8 prompt tokens) of qwen-smoke (4 kv heads
  x 16), internlm2-smoke (2 kv heads: GQA) and whisper-smoke (4 x 16, its
  12 encoder frames), with 3 generated tokens (``max_len`` 12, which 3 and
  6 divide: the sequence over 'model') and 4 (``max_len`` 13: the cache
  whole);
* qwen-smoke's engines under ``SimClock``: the slot engine (``max_len``
  18: its lanes' sequence over 'model', a one-row admission's prompt of 8
  whole), the paged engine (its pool whole over 'model'), the same with
  the int8 pool (its per-block scales whole too) and the speculative
  engine with a float draft (the draft's contiguous cache over 'model').

Stated beforehand: every static step's logits within rtol = atol = 1e-4
(TOL) of the reference's over the same mesh, the tokens equal up to each
row's first near-tie (the reference's top-2 margin within TOL of 1 +
|top|); each engine's admission sequence equal, its tokens equal up to
each request's first near-tie (the speculative engine's whole) and every
request's first-token logits within TOL; every rank alike; each static
step's and each engine step's collective bytes by kind those of the same
step on an abstract mesh (``launch.dryrun.serve_cell`` /
``engine_cells``); each rank's cache of the sequence block its layout
names.

Found, and how the int8 pool is held: at this seed the port's one-device
int8-pool engine lies beyond TOL of the reference's one device in two
requests' first-token logits, named in ``TIES`` (request 2: 0.00298;
request 4: 5.6e-4), and the reference's own engine moves request 2 by as
much between its 1 x 1 and 1 x 2 meshes. Both start at a tie of the
pool's quantizer, which :func:`test_int8_pool_gaps_start_at_a_quantizer_tie`
shows from both packages' ``quantize_block`` inputs: every block
quantized alike up to one call (the 39th), whose inputs agree within
1.7e-6, and there one element lands one int8 step apart, its f64
quotients x / s on either side of the same k + 1/2 (K element (0, 1, 2,
2), 0.41910154 in the reference and 0.41910055 in the port, quotients
18.500003 and 18.499960). Those two requests' first-token logits are
held to the port's engine on one device, every other request's to the
reference's over the same mesh, and the int8 pool's admissions and
tokens to the reference's.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import models as RM
from repro_torch import configs as C
from repro_torch import interop
from repro_torch import serve as TS
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, DRAFT_SEED, SPEC_K = 6, 7, 2
TOL = 1e-4
ROWS, PROMPT = 4, 8
MESHES = {"2x3": (2, 3), "1x6": (1, 6)}
# the static server's runs: (arch, mesh, generated tokens); max_len is
# PROMPT + gen + 1: 12 (3 and 6 divide it) or 13 (neither does)
STATIC = [(a, m, g) for a in ("qwen1.5-4b", "internlm2-20b",
                              "whisper-base")
          for m in MESHES for g in (3, 4)]
ENGINES = [(e, m) for e in ("slot", "paged", "paged_int8", "spec")
           for m in MESHES]
ARCHS = sorted({a for a, _, _ in STATIC})
TIMEOUT = 600  # seconds, each job
# engine mode: the requests whose first-token logits the port's and the
# reference's one-device engines part at a quantizer tie (module
# docstring)
TIES = {"paged_int8": (2, 4)}

ENGINE_SRC = r'''
def engine_kw(pkg, mode, vocab, draft):
    """(engine keyword arguments, trace) of one mode (the same seeds in
    both packages): the slot engine, the paged engine (with the int8
    pool: "paged_int8"), the paged engine with a float draft ("spec")."""
    if mode == "slot":
        return (dict(num_slots=2, max_len=18, prompt_pad=8,
                     clock=pkg.SimClock(1e-3)),
                pkg.synthetic_trace(4, vocab_size=vocab,
                                    prompt_lens=[8, 4, 6],
                                    max_new_tokens=[4, 2, 3], seed=7))
    kw = dict(num_slots=4, max_len=24, prompt_pad=8, kv_block_size=4,
              num_kv_blocks=18, prefill_chunk=4, clock=pkg.SimClock(1e-3))
    if mode == "paged_int8":
        kw["kv_quantize"] = "int8"
    if mode == "spec":
        kw.update(draft, spec_k=SPEC_K)
    return kw, pkg.synthetic_trace(5, vocab_size=vocab, prompt_lens=[8, 5],
                                   max_new_tokens=[5, 3], seed=2)


def record_samples(engine, vocab):
    """Wrap ``engine._sample``: every sampled row (the true vocabulary) in
    order, with its request id."""
    log, sample = [], engine._sample

    def recorded(row, st):
        log.append((st.request.request_id,
                    np.asarray(row[:vocab], np.float32).copy()))
        return sample(row, st)

    engine._sample = recorded
    return log


def outcome(engine, trace, log):
    """The admission sequence, the tokens and every sampled row, by trace
    index (request ids differ from run to run)."""
    ids = {r.request_id: i for i, r in enumerate(trace)}
    seq = [[ids[st.request.request_id], st.slot, st.admitted_tick,
            st.first_token_tick, st.finished_tick, st.finish_reason]
           for st in engine.finished]
    toks = {ids[st.request.request_id]: [int(t) for t in st.tokens]
            for st in engine.finished}
    rows = {}
    for rid, row in log:
        rows.setdefault(ids[rid], []).append(row)
    return seq, toks, rows
'''

REF_PROG = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as RC, models as RM, serve as RS
from repro.compat import mesh_from_devices
from repro.core.context import use_context
from repro.core.plancache import PlanCache
from repro.parallel import sharding as rshd
from repro.quant import int8 as q8
from repro.train.servestep import make_serve_step

work = sys.argv[1]
SEED, DRAFT_SEED, SPEC_K, ROWS, PROMPT, MESHES, STATIC, ENGINES, TIES = \
    {consts}
{engine}
z = np.load(os.path.join(work, "inputs.npz"))
out, res, trees = {{}}, {{}}, {{}}
calls, _quantize_block = [], q8.quantize_block


def recorded(x):
    """q8.quantize_block, recording every call's input, in order."""
    jax.debug.callback(lambda a: calls.append(np.asarray(a, np.float32)),
                       x, ordered=True)
    return _quantize_block(x)


def mesh_of(name):
    d, m = MESHES[name]
    return mesh_from_devices(np.array(jax.devices()[:d * m]).reshape(d, m),
                             ("data", "model"))


def tree(arch, seed=SEED):
    if (arch, seed) not in trees:
        rcfg = RC.smoke(RC.get_config(arch))
        trees[arch, seed] = (rcfg, RM.init(jax.random.PRNGKey(seed), rcfg))
    return trees[arch, seed]


with use_context(plan_cache=PlanCache()):
    for arch, mname, gen in STATIC:
        rcfg, rp = tree(arch)
        mesh = mesh_of(mname)
        max_len = PROMPT + gen + 1
        sart = make_serve_step(rcfg, mesh, batch=ROWS, max_len=max_len)
        tok_shard = jax.sharding.NamedSharding(mesh, rshd.batch_specs(
            {{"t": jax.ShapeDtypeStruct((ROWS, 1), jnp.int32)}}, mesh)["t"])
        batch = {{"tokens": jnp.asarray(z["prompts"])}}
        if f"{{arch}}/frames" in z:
            batch["frames"] = jnp.asarray(z[f"{{arch}}/frames"])
        key = f"serve/{{arch}}/{{mname}}/{{gen}}"
        with mesh:
            st = jax.jit(lambda: RM.init_decode_state(rcfg, ROWS, max_len),
                         out_shardings=sart.state_shardings)()
            logits, st = sart.prefill_fn(rp, st, batch)
            for i in range(gen + 1):
                out[f"{{key}}/logits{{i}}"] = np.asarray(
                    logits, np.float32)[:, :rcfg.vocab_size]
                if i == gen:
                    break
                tok = jnp.argmax(logits[:, :rcfg.vocab_size], -1).astype(
                    jnp.int32)
                logits, st = sart.decode_fn(rp, st, jax.device_put(
                    tok[:, None], tok_shard))
    rcfg, rp = tree("qwen1.5-4b")
    draft = dict(spec_draft_cfg=rcfg,
                 spec_draft_params=tree("qwen1.5-4b", DRAFT_SEED)[1])
    for mode, mname in ENGINES:
        kw, trace = engine_kw(RS, mode, rcfg.vocab_size, draft)
        engine = RS.ServeEngine(rcfg, mesh_of(mname), rp, **kw)
        log = record_samples(engine, rcfg.vocab_size)
        engine.run(trace)
        seq, toks, rows = outcome(engine, trace, log)
        key = f"engine/{{mode}}/{{mname}}"
        res[key] = {{"seq": seq, "tokens": toks}}
        for i, r in rows.items():
            out[f"{{key}}/rows{{i}}"] = np.stack(r)
    # one device, every pool quantization's input recorded
    for mode in TIES:
        kw, trace = engine_kw(RS, mode, rcfg.vocab_size, draft)
        q8.quantize_block = recorded
        try:
            engine = RS.ServeEngine(rcfg, mesh_from_devices(np.array(
                jax.devices()[:1]).reshape(1, 1), ("data", "model")), rp,
                **kw)
            log = record_samples(engine, rcfg.vocab_size)
            engine.run(trace)
            jax.effects_barrier()
        finally:
            q8.quantize_block = _quantize_block
        key = f"engine/{{mode}}/one"
        for i, r in outcome(engine, trace, log)[2].items():
            out[f"{{key}}/rows{{i}}"] = np.stack(r)
        for i, x in enumerate(calls):
            out[f"{{key}}/q{{i}}"] = x
np.savez(os.path.join(work, "ref.npz"), **out)
with open(os.path.join(work, "ref.json"), "w") as f:
    json.dump(res, f)
'''

PROG = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs as C
from repro_torch import models
from repro_torch import serve as TS
from repro_torch.core.context import use_context
from repro_torch.core.distributed import data_parallel
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items, tree_map
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import serve_batch
from repro_torch.parallel import sharding as shd
from repro_torch.quant import int8 as q8
from repro_torch.train.servestep import param_blocks

work = sys.argv[2]
SEED, DRAFT_SEED, SPEC_K, ROWS, PROMPT, MESHES, STATIC, ENGINES, TIES = \
    {consts}
{engine}
z = np.load(os.path.join(work, "inputs.npz"))
res, arrays = {{}}, {{}}
calls, _quantize_block = [], q8.quantize_block


def recorded(x, reduce=None):
    """q8.quantize_block, recording every call's input on a device (not
    the plan warm-up's meta tensors), in order."""
    if x.device.type != "meta":
        calls.append(x.detach().float().numpy().copy())
    return _quantize_block(x, reduce)


def weights(arch, tag="target"):
    cfg = C.smoke(C.get_config(arch))
    w = np.load(os.path.join(work, f"{{arch}}_{{tag}}.npz"))
    shapes = models.init(cfg, device="meta")
    it = iter([torch.from_numpy(w[p].copy()) for p, _ in tree_items(shapes)])
    return cfg, tree_map(lambda _: next(it), shapes)


def static(key, arch, mesh, gen):
    """The static server's tokens, every step's logits (whole over DP),
    collective bytes by kind and this rank's cache shape."""
    cfg, whole = weights(arch)
    extras = {{"frames": torch.from_numpy(z[f"{{arch}}/frames"].copy())}} \
        if f"{{arch}}/frames" in z else {{}}
    rec = {{}}
    toks = serve_batch(cfg, param_blocks(cfg, whole, mesh), torch.from_numpy(
        z["prompts"].copy()).long(), gen_len=gen,
        max_len=PROMPT + gen + 1, extras=extras, mesh=mesh, record=rec)
    logits = rec["logits"]
    if logits[0].shape[0] != ROWS:
        entry = data_parallel(mesh)[0]
        logits = [shd.gather_leaf(t, shd.P(entry), mesh) for t in logits]
    res[key] = {{"tokens": toks.tolist(), "prefill": rec["prefill_by_kind"],
                "decode": rec["decode_by_kind"],
                "cache": list(rec["state"]["kv"].k.shape)}}
    for i, t in enumerate(logits):
        arrays[f"{{key}}/{{i}}"] = t[:, :cfg.vocab_size].numpy()


def engine(key, mode, mesh):
    """The engine over ``mesh``: its outcome, step bytes by kind, this
    rank's cache shape and sampled rows; the int8 pool's also on one
    device (``key``/one)."""
    cfg, whole = weights("qwen1.5-4b")
    draft = dict(spec_draft_cfg=cfg,
                 spec_draft_params=weights("qwen1.5-4b", "draft")[1])
    for m in (mesh, None) if mode == "paged_int8" else (mesh,):
        kw, trace = engine_kw(TS, mode, cfg.vocab_size, draft)
        eng = TS.ServeEngine(cfg, whole, mesh=m, **kw)
        log = record_samples(eng, cfg.vocab_size)
        eng.plan_warmup()
        calls.clear()
        if m is None and mode in TIES:
            q8.quantize_block = recorded
        try:
            eng.run(trace)
        finally:
            q8.quantize_block = _quantize_block
        seq, toks, rows = outcome(eng, trace, log)
        tag = key if m is not None else key + "/one"
        for i, x in enumerate(calls):
            arrays[f"{{tag}}/q{{i}}"] = x
        res[tag] = {{"seq": seq, "tokens": toks,
                    "kinds": {{k: [dict(s) for s in v]
                              for k, v in eng.step_kinds.items()}},
                    "cache": list(eng.state["kv"].k.shape)}}
        for i, r in rows.items():
            arrays[f"{{tag}}/{{i}}"] = np.stack(r)


with use_context(plan_cache=PlanCache()):
    meshes = {{n: make_local_mesh(*s, device="cpu")
              for n, s in MESHES.items()}}
    for arch, mname, gen in STATIC:
        static(f"serve/{{arch}}/{{mname}}/{{gen}}", arch, meshes[mname], gen)
    for mode, mname in ENGINES:
        engine(f"engine/{{mode}}/{{mname}}", mode, meshes[mname])
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
rank = dist.get_rank()
with open(os.path.join(work, f"rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
np.savez(os.path.join(work, f"rank{{rank}}.npz"), **arrays)
dist.destroy_process_group()
'''

exec(ENGINE_SRC)

CONSTS = (SEED, DRAFT_SEED, SPEC_K, ROWS, PROMPT, MESHES, STATIC, ENGINES,
          TIES)
NPROC = 6



def _inputs(work: str) -> None:
    """The prompts, whisper's encoder frames, and each smoke model's
    reference init (qwen's draft too) as the port's tree."""
    rng = np.random.default_rng(SEED)
    vocab = min(RC.smoke(RC.get_config(a)).vocab_size for a in ARCHS)
    arrays = {"prompts": rng.integers(0, vocab, size=(ROWS, PROMPT)).astype(
        np.int32)}
    for arch in ARCHS:
        rcfg, cfg = RC.smoke(RC.get_config(arch)), C.smoke(C.get_config(arch))
        if cfg.family == "encdec":
            arrays[f"{arch}/frames"] = rng.standard_normal(
                (ROWS, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        seeds = {"target": SEED}
        if arch == "qwen1.5-4b":
            seeds["draft"] = DRAFT_SEED
        for tag, seed in seeds.items():
            tree = jax.tree.map(np.asarray,
                                RM.init(jax.random.PRNGKey(seed), rcfg))
            port = interop.params_from_jax(tree, cfg, "cpu")
            np.savez(os.path.join(work, f"{arch}_{tag}.npz"),
                     **{p: t.numpy() for p, t in tree_items(port)})
    np.savez(os.path.join(work, "inputs.npz"), **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("cache_fallback"))
    _inputs(work)
    ref_path, prog = (os.path.join(work, n) for n in ("ref.py", "rank.py"))
    with open(ref_path, "w") as f:
        f.write(REF_PROG.format(consts=CONSTS, engine=ENGINE_SRC))
    with open(prog, "w") as f:
        f.write(PROG.format(consts=CONSTS, engine=ENGINE_SRC))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen([sys.executable, ref_path, work], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    port = free_port()
    for rank in range(NPROC):
        procs.append(subprocess.Popen(
            [sys.executable, prog, "mesh", work], cwd=ROOT,
            env={**env, "RANK": str(rank), "WORLD_SIZE": str(NPROC),
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    load = lambda name: json.load(open(os.path.join(work, name + ".json")))
    npz = lambda name: dict(np.load(os.path.join(work, name + ".npz")))
    return {"ref": load("ref"), "ref_arrays": npz("ref"),
            "ranks": [load(f"rank{r}") for r in range(NPROC)],
            "arrays": npz("rank0")}


def _close(got, want, msg="") -> None:
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=msg)


def _clear(row) -> bool:
    """The row's top-2 margin exceeds TOL of 1 + |top|: no near-tie."""
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return top[1] - top[0] > TOL * (1 + abs(top[1]))


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for r in runs["ranks"])


@pytest.mark.parametrize("arch,mesh,gen", STATIC)
def test_static_server_matches_reference_over_mesh(runs, arch, mesh, gen):
    key = f"serve/{arch}/{mesh}/{gen}"
    got = runs["ranks"][0][key]
    live = [True] * ROWS  # rows before their first near-tie
    for i in range(gen + 1):
        want = runs["ref_arrays"][f"{key}/logits{i}"]
        _close(runs["arrays"][f"{key}/{i}"], want, f"step {i}")
        if i == gen:
            break
        for row in range(ROWS):
            live[row] = live[row] and _clear(want[row])
            if live[row]:
                assert got["tokens"][row][i] == int(np.argmax(want[row]))
    for rec in runs["ranks"][1:]:
        assert rec[key]["tokens"] == got["tokens"]


@pytest.mark.parametrize("mode,mesh", ENGINES)
def test_engine_matches_reference_over_mesh(runs, mode, mesh):
    key = f"engine/{mode}/{mesh}"
    want, got = runs["ref"][key], runs["ranks"][0][key]
    assert got["seq"] == want["seq"]
    for i, toks in want["tokens"].items():
        rows = runs["ref_arrays"][f"{key}/rows{i}"]
        n = len(toks)
        if mode != "spec":  # up to the request's first near-tie
            n = next((j for j, r in enumerate(rows) if not _clear(r)), n)
        assert got["tokens"][i][:n] == toks[:n], (i, got["tokens"][i], toks)
        # the first token's logits, before any stream can fork; a request
        # of TIES against the port's engine on one device
        if int(i) in TIES.get(mode, ()):
            rows = runs["arrays"][f"{key}/one/{i}"]
            assert runs["ranks"][0][key + "/one"]["tokens"][i] == \
                got["tokens"][i]
        _close(runs["arrays"][f"{key}/{i}"][0], rows[0], f"request {i}")
    for rec in runs["ranks"][1:]:
        assert rec[key]["tokens"] == got["tokens"]
        assert rec[key]["kinds"] == got["kinds"]


@pytest.mark.parametrize("mode", sorted(TIES))
def test_int8_pool_gaps_start_at_a_quantizer_tie(runs, mode):
    """On one device, the port's int8-pool engine's first-token logits lie
    beyond TOL of the reference's in the requests ``TIES`` names and
    within TOL in every other; and both packages quantize every pool
    block alike (each package's ``quantize_block`` input, quantized here
    as both quantize: per block and kv head, half to even) up to one
    call, whose inputs agree within TOL, and there one element alone
    lands one int8 step apart, its f64 quotients x / s on either side of
    the same k + 1/2."""
    key = f"engine/{mode}/one"  # the reference's; the port's beside a mesh
    mine = f"engine/{mode}/{next(iter(MESHES))}/one"
    arrays, ref = runs["arrays"], runs["ref_arrays"]
    n = sum(k.startswith(f"{key}/rows") for k in ref)
    assert n == len(runs["ranks"][0][mine]["tokens"])
    for i in range(n):
        close = np.allclose(arrays[f"{mine}/{i}"][0],
                            ref[f"{key}/rows{i}"][0], rtol=TOL, atol=TOL)
        assert close == (i not in TIES[mode]), i
    calls = lambda a, k: [a[f"{k}/q{i}"] for i in range(sum(
        n.startswith(f"{k}/q") for n in a))]
    got, want = calls(arrays, mine), calls(ref, key)
    assert len(got) == len(want) > 0

    def quantize(x):
        amax = np.abs(x).max(axis=(-3, -1))
        s = np.where(amax > 0, np.maximum(amax, np.float32(1e-12))
                     / np.float32(127), np.float32(1)).astype(np.float32)
        return np.clip(np.round(x / s[..., None, :, None]), -127, 127), s

    for c, (x, rx) in enumerate(zip(got, want)):
        assert x.shape == rx.shape, c
        (q, s), (rq, rs) = quantize(x), quantize(rx)
        apart = np.argwhere(q != rq)
        if len(apart):
            break
    else:
        raise AssertionError("no pool block quantized apart")
    _close(x, rx, f"call {c}")
    assert len(apart) == 1, (c, apart[:4])
    at = tuple(apart[0])
    head = at[:-3] + (at[-2],)
    assert abs(q[at] - rq[at]) == 1
    mine_q = np.float64(x[at]) / np.float64(s[head])
    ref_q = np.float64(rx[at]) / np.float64(rs[head])
    k = np.floor(min(mine_q, ref_q)) + 0.5  # the boundary between them
    assert min(mine_q, ref_q) <= k <= max(mine_q, ref_q), (c, at, mine_q,
                                                           ref_q)


def _static_cells(arch, mesh, gen):
    cfg = C.smoke(C.get_config(arch))
    abstract = Mesh(("data", "model"), MESHES[mesh])
    with use_context(plan_cache=PlanCache()):
        return (dryrun.serve_cell(cfg, abstract, "prefill", ROWS, PROMPT)[
                    "cost"]["by_collective"],
                dryrun.serve_cell(cfg, abstract, "decode", ROWS,
                                  PROMPT + gen + 1)["cost"]["by_collective"])


@pytest.mark.parametrize("arch,mesh,gen", STATIC)
def test_static_step_bytes_are_the_dry_runs(runs, arch, mesh, gen):
    """Each step's bytes by kind are the abstract mesh's; over a cache
    whose sequence lies over 'model' the decode step all-gathers each
    rank's f32 max and sum a row and head, and all-reduces the f32
    head_dim weighted V a row and head, a layer."""
    cfg = C.smoke(C.get_config(arch))
    pre, dec = _static_cells(arch, mesh, gen)
    key = f"serve/{arch}/{mesh}/{gen}"
    for rec in runs["ranks"]:
        got = rec[key]
        assert got["prefill"] == pre
        assert all(s == dec for s in got["decode"])
    data, model = MESHES[mesh]
    max_len = PROMPT + gen + 1
    seq = max_len % model == 0
    assert runs["ranks"][0][key]["cache"] == [
        cfg.n_layers, ROWS // data, max_len // model if seq else max_len,
        cfg.n_kv_heads, cfg.head_dim]
    if seq and data == 1:  # every row on every rank: only the softmax's
        row_heads = cfg.n_layers * ROWS * cfg.n_heads * 4
        assert dec == {"all_gather": row_heads * 2,
                       "all_reduce": row_heads * cfg.head_dim}


_ENGINE_CELLS = {}


@pytest.mark.parametrize("mode,mesh", ENGINES)
def test_engine_step_bytes_are_the_dry_runs(runs, mode, mesh):
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    kw, _ = engine_kw(TS, mode, cfg.vocab_size, {})
    with use_context(plan_cache=PlanCache()):
        cells = dryrun.engine_cells(
            cfg, Mesh(("data", "model"), MESHES[mesh]),
            num_slots=kw["num_slots"], max_len=kw["max_len"],
            prompt_pad=kw["prompt_pad"],
            kv_block_size=kw.get("kv_block_size"),
            num_kv_blocks=kw.get("num_kv_blocks"),
            prefill_chunk=kw.get("prefill_chunk"),
            kv_dtype=kw.get("kv_quantize"),
            draft_cfg=cfg if mode == "spec" else None, spec_k=SPEC_K)
    key = f"engine/{mode}/{mesh}"
    for rec in runs["ranks"]:
        got = rec[key]["kinds"]
        assert got and set(got) <= set(cells)
        for tag, seen in got.items():
            assert all(s == cells[tag]["by_collective"] for s in seen), tag
    data, model = MESHES[mesh]
    lanes = kw["num_slots"] // data
    shape = runs["ranks"][0][key]["cache"]
    if mode == "slot":  # the lanes' sequence over 'model'
        assert shape == [cfg.n_layers, lanes, kw["max_len"] // model,
                         cfg.n_kv_heads, cfg.head_dim]
        assert cells["decode"]["by_collective"]["all_gather"] > 0
    else:  # the pool's blocks over 'data', whole over 'model'
        assert shape == [cfg.n_layers, kw["num_kv_blocks"] // data,
                         kw["kv_block_size"], cfg.n_kv_heads, cfg.head_dim]
