"""int8 serving over a mesh on the CPU: W8A8 (pre-quantized weights and
the dynamic path), tensor-parallel over 'model', and the int8 KV pool,
against the reference over the same mesh.

The reference serves int8 over any mesh: its steps are ``jit`` with
``NamedSharding``s, and under GSPMD a W8A8 activation's ``jnp.max`` spans
the whole global tensor. The port holds each rank's share of it and takes
the MAX over the ranks that hold the rest (``core.distributed.scale_max``):
the DP ranks where the step's rows are cut, 'model' for a row-parallel
block's K, the MoE router excepted (the reference computes it inside
``shard_map``, per shard).

This process draws the prompts (numpy, seed ``SEED``) and the reference's
init of each smoke model (``PRNGKey(SEED)``; the draft's
``PRNGKey(DRAFT_SEED)``), writes the port's trees to an .npz, then runs
at once: the reference in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, each tree
quantized by ``quant.prequant`` and served under ``quant_mode="int8"``, as
its launcher does), 8 gloo ranks, a 2-rank job (2 x 1) and a 1-rank job,
whose ranks import no JAX and quantize the same float trees with the
port's ``quantize_params``:

* the static server (``make_serve_step`` over the mesh, 4 rows, 8 prompt
  tokens, 4 generated): qwen-smoke (4 kv heads) over 4 x 2, 2 x 4 (the
  kv-heads layout) and 1 x 8 (attention's 'seq' mode: 4 heads do not
  divide 8; the head_dim cache), internlm2-smoke (2 kv heads: the head_dim
  cache) over 2 x 4, olmoe-smoke over 2 x 4 (expert parallelism over
  'data' beside W8A8 attention over 'model'), and qwen-smoke's float tree
  under ``quant_mode="int8"`` (the dynamic path) over 4 x 2;
* the paged engine with pre-quantized weights and ``kv_quantize="int8"``
  over the three meshes, and the speculative engine with an int8 draft
  over 2 x 4, under ``SimClock``;
* 2 x 1 (the fault this slice repairs: a scale over one rank's rows):
  the static server, the slot engine and the paged engine against the
  one-device path; 1 x 1 bit for bit against it.

Stated beforehand: every step's logits within rtol = atol = 1e-4 (TOL,
``tests/test_torch_quant.py``'s tolerance for the one-device int8
forward) of the reference's over the same mesh, and of the one device's on
2 x 1; the tokens equal up to each request's first near-tie (the
reference's top-2 margin within TOL of 1 + |top|), the admission sequence
equal; every rank alike; a 1 x 1 mesh the one-device path bit for bit; a
dynamic step's collective bytes the float step's dry-run cell plus the
counted ``scale_max`` reductions, a pre-quantized step's those of the same
step on an abstract mesh, with every kind but the parameter gathers (int8
now) the float cell's.
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
from repro_torch import models
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, free_port
from repro_torch.layers.attention import init_paged_kv_cache
from repro_torch.quant.prequant import quantize_params
from repro_torch.train.servestep import make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, DRAFT_SEED, SPEC_K = 3, 4, 2
TOL = 1e-4
SERVE = (4, 8, 4)  # rows, prompt tokens, generated tokens
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}
# the static server's runs: (arch, mesh, "pre" | "dyn")
STATIC = [("qwen1.5-4b", m, "pre") for m in MESHES] + [
    ("internlm2-20b", "2x4", "pre"), ("olmoe-1b-7b", "2x4", "pre"),
    ("qwen1.5-4b", "4x2", "dyn")]
# the engines' runs: (mode, mesh)
ENGINES = [("paged", m) for m in MESHES] + [("spec", "2x4")]
ARCHS = sorted({a for a, _, _ in STATIC})
TIMEOUT = 600  # seconds, each job

ENGINE_SRC = r'''
def engine_kw(pkg, mode, vocab, draft=None):
    """(engine keyword arguments, trace) of one mode (the same seeds in
    both packages): the paged engine with the int8 pool, with an int8
    draft ("spec"), or the slot engine ("slot")."""
    if mode == "slot":
        return (dict(num_slots=2, max_len=16, prompt_pad=8,
                     clock=pkg.SimClock(1e-3)),
                pkg.synthetic_trace(4, vocab_size=vocab,
                                    prompt_lens=[8, 4, 6],
                                    max_new_tokens=[4, 2, 3], seed=7))
    kw = dict(num_slots=4, max_len=24, prompt_pad=8, kv_block_size=4,
              num_kv_blocks=18, prefill_chunk=4, kv_quantize="int8",
              clock=pkg.SimClock(1e-3))
    if mode == "spec":
        kw.update(draft, spec_k=SPEC_K, spec_draft_quant="int8")
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
from repro.quant import prequant
from repro.train.servestep import make_serve_step

work = sys.argv[1]
SEED, DRAFT_SEED, SPEC_K, SERVE, MESHES, STATIC, ENGINES = {consts}
{engine}
z = np.load(os.path.join(work, "inputs.npz"))
out, res = {{}}, {{}}


def tree(arch, seed, quant):
    rcfg = RC.smoke(RC.get_config(arch))
    rp = RM.init(jax.random.PRNGKey(seed), rcfg)
    if quant != "pre":
        return rcfg, rp, None
    return (rcfg, prequant.quantize_params(rp),
            prequant.quantize_axes(RM.axes(rcfg)))


def mesh_of(name):
    return mesh_from_devices(np.array(jax.devices()).reshape(*MESHES[name]),
                             ("data", "model"))


with use_context(quant_mode="int8", plan_cache=PlanCache()):
    for arch, mname, quant in STATIC:
        rcfg, rp, axes = tree(arch, SEED, quant)
        mesh = mesh_of(mname)
        B, P, gen = SERVE
        max_len = P + gen + 1
        sart = make_serve_step(
            rcfg, mesh, batch=B, max_len=max_len, param_axes=axes,
            param_shapes=None if axes is None else jax.eval_shape(
                lambda: rp))
        tok_shard = jax.sharding.NamedSharding(mesh, rshd.batch_specs(
            {{"t": jax.ShapeDtypeStruct((B, 1), jnp.int32)}}, mesh)["t"])
        key = f"serve/{{arch}}/{{mname}}/{{quant}}"
        with mesh:
            st = jax.jit(lambda: RM.init_decode_state(rcfg, B, max_len),
                         out_shardings=sart.state_shardings)()
            logits, st = sart.prefill_fn(
                rp, st, {{"tokens": jnp.asarray(z["prompts"])}})
            for i in range(gen):
                out[f"{{key}}/logits{{i}}"] = np.asarray(
                    logits, np.float32)[:, :rcfg.vocab_size]
                tok = jnp.argmax(logits[:, :rcfg.vocab_size], -1).astype(
                    jnp.int32)
                logits, st = sart.decode_fn(rp, st, jax.device_put(
                    tok[:, None], tok_shard))
    rcfg, rq, axes = tree("qwen1.5-4b", SEED, "pre")
    _, rd, _ = tree("qwen1.5-4b", DRAFT_SEED, "pre")
    draft = dict(spec_draft_cfg=rcfg, spec_draft_params=rd,
                 spec_draft_param_axes=axes)
    for mode, mname in ENGINES:
        kw, trace = engine_kw(RS, mode, rcfg.vocab_size, draft)
        engine = RS.ServeEngine(rcfg, mesh_of(mname), rq, param_axes=axes,
                                **kw)
        log = record_samples(engine, rcfg.vocab_size)
        engine.run(trace)
        seq, toks, rows = outcome(engine, trace, log)
        key = f"engine/{{mode}}/{{mname}}"
        res[key] = {{"seq": seq, "tokens": toks}}
        for i, r in rows.items():
            out[f"{{key}}/rows{{i}}"] = np.stack(r)
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
from repro_torch.quant.prequant import quantize_params
from repro_torch.train.servestep import param_blocks

mode, work = sys.argv[1], sys.argv[2]
SEED, DRAFT_SEED, SPEC_K, SERVE, MESHES, STATIC, ENGINES = {consts}
{engine}
z = np.load(os.path.join(work, "inputs.npz"))
res, arrays = {{}}, {{}}


def weights(arch, tag="target"):
    cfg = C.smoke(C.get_config(arch))
    w = np.load(os.path.join(work, f"{{arch}}_{{tag}}.npz"))
    shapes = models.init(cfg, device="meta")
    it = iter([torch.from_numpy(w[p].copy()) for p, _ in tree_items(shapes)])
    return cfg, tree_map(lambda _: next(it), shapes)


def static(arch, mesh, quant):
    """The static server's tokens, every step's logits (whole over DP) and
    collective bytes by kind."""
    cfg, whole = weights(arch)
    B, P, gen = SERVE
    if quant == "pre":
        whole = quantize_params(whole)
    blocks = whole if mesh is None else param_blocks(
        cfg, whole, mesh, quantized=quant == "pre")
    rec = {{}}
    toks = serve_batch(cfg, blocks, torch.from_numpy(
        z["prompts"].copy()).long(), gen_len=gen, max_len=P + gen + 1,
        mesh=mesh, record=rec)
    logits = rec["logits"][:gen]
    if mesh is not None and logits[0].shape[0] != B:
        entry = data_parallel(mesh)[0]
        logits = [shd.gather_leaf(t, shd.P(entry), mesh) for t in logits]
    return {{"tokens": toks.tolist(),
            "prefill": rec.get("prefill_by_kind", {{}}),
            "decode": [d for d in rec.get("decode_by_kind", [])]}}, [
        t[:, :cfg.vocab_size].numpy() for t in logits]


def engine(mode, mesh):
    cfg, whole = weights("qwen1.5-4b")
    _, dwhole = weights("qwen1.5-4b", "draft")
    draft = dict(spec_draft_cfg=cfg,
                 spec_draft_params=quantize_params(dwhole))
    kw, trace = engine_kw(TS, mode, cfg.vocab_size, draft)
    eng = TS.ServeEngine(cfg, quantize_params(whole), mesh=mesh, **kw)
    log = record_samples(eng, cfg.vocab_size)
    eng.plan_warmup()
    eng.run(trace)
    seq, toks, rows = outcome(eng, trace, log)
    return {{"seq": seq, "tokens": toks,
            "total": {{k: sorted(set(v)) for k, v in
                      eng.step_bytes.items()}}}}, rows


def keep(key, rec, rows):
    res[key] = rec
    for i, r in (rows.items() if isinstance(rows, dict) else
                 enumerate(rows)):
        arrays[f"{{key}}/{{i}}"] = np.stack(r) if isinstance(r, list) else r


with use_context(quant_mode="int8", plan_cache=PlanCache()):
    if mode == "mesh8":
        meshes = {{n: make_local_mesh(*s, device="cpu")
                  for n, s in MESHES.items()}}
        for arch, mname, quant in STATIC:
            keep(f"serve/{{arch}}/{{mname}}/{{quant}}",
                 *static(arch, meshes[mname], quant))
        for emode, mname in ENGINES:
            keep(f"engine/{{emode}}/{{mname}}", *engine(emode,
                                                      meshes[mname]))
    else:  # "mesh2": 2 x 1; "mesh1": 1 x 1 and the one device
        shapes = {{"mesh2": [(2, 1)], "mesh1": [(1, 1), None]}}[mode]
        for shape in shapes:
            mesh = None if shape is None else make_local_mesh(
                *shape, device="cpu")
            tag = "one" if shape is None else "x".join(map(str, shape))
            keep(f"serve/{{tag}}", *static("qwen1.5-4b", mesh, "pre"))
            for emode in ("slot", "paged"):
                keep(f"engine/{{emode}}/{{tag}}", *engine(emode, mesh))
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
rank = dist.get_rank()
with open(os.path.join(work, f"{{mode}}_rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
np.savez(os.path.join(work, f"{{mode}}_rank{{rank}}.npz"), **arrays)
dist.destroy_process_group()
'''

exec(ENGINE_SRC)



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


def _inputs(work: str) -> None:
    """The prompts, and each smoke model's reference init (the draft's
    too) as the port's float tree."""
    rng = np.random.default_rng(SEED)
    vocab = min(RC.smoke(RC.get_config(a)).vocab_size for a in ARCHS)
    np.savez(os.path.join(work, "inputs.npz"), prompts=rng.integers(
        0, vocab, size=SERVE[:2]).astype(np.int32))
    for arch in ARCHS:
        rcfg, cfg = RC.smoke(RC.get_config(arch)), C.smoke(C.get_config(arch))
        seeds = {"target": SEED}
        if arch == "qwen1.5-4b":
            seeds["draft"] = DRAFT_SEED
        for tag, seed in seeds.items():
            tree = jax.tree.map(np.asarray,
                                RM.init(jax.random.PRNGKey(seed), rcfg))
            port = interop.params_from_jax(tree, cfg, "cpu")
            np.savez(os.path.join(work, f"{arch}_{tag}.npz"),
                     **{p: t.numpy() for p, t in tree_items(port)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("int8_mesh"))
    _inputs(work)
    consts = (SEED, DRAFT_SEED, SPEC_K, SERVE, MESHES, STATIC, ENGINES)
    ref_path, prog = (os.path.join(work, n) for n in ("ref.py", "rank.py"))
    with open(ref_path, "w") as f:
        f.write(REF_PROG.format(consts=consts, engine=ENGINE_SRC))
    with open(prog, "w") as f:
        f.write(PROG.format(consts=consts, engine=ENGINE_SRC))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    ref = subprocess.Popen([sys.executable, ref_path, work], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    jobs = (_spawn(prog, "mesh8", 8, work) + _spawn(prog, "mesh2", 2, work)
            + _spawn(prog, "mesh1", 1, work))
    _wait(jobs + [ref], TIMEOUT)
    load = lambda name: json.load(open(os.path.join(work, name + ".json")))
    npz = lambda name: dict(np.load(os.path.join(work, name + ".npz")))
    return {"ref": load("ref"), "ref_arrays": npz("ref"),
            "mesh8": [load(f"mesh8_rank{r}") for r in range(8)],
            "mesh8_arrays": npz("mesh8_rank0"),
            "mesh2": [load(f"mesh2_rank{r}") for r in range(2)],
            "mesh2_arrays": npz("mesh2_rank0"),
            "mesh1": load("mesh1_rank0"), "mesh1_arrays": npz("mesh1_rank0")}


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _upto(rows: list) -> int:
    """How many of a request's sampled rows precede its first near-tie."""
    for n, row in enumerate(rows):
        top = np.sort(row.astype(np.float64))[-2:]
        if not top[1] - top[0] > TOL * (1 + abs(top[1])):
            return n
    return len(rows)


def test_ranks_import_no_jax(runs):
    recs = runs["mesh8"] + runs["mesh2"] + [runs["mesh1"]]
    assert not any(r["jax_imported"] for r in recs)


@pytest.mark.parametrize("arch,mesh,quant", STATIC)
def test_static_server_matches_reference_over_mesh(runs, arch, mesh,
                                                   quant):
    key = f"serve/{arch}/{mesh}/{quant}"
    got = runs["mesh8"][0][key]
    held = 0
    for i in range(SERVE[2]):
        want = runs["ref_arrays"][f"{key}/logits{i}"]
        _close(runs["mesh8_arrays"][f"{key}/{i}"], want)
        for row in range(SERVE[0]):
            top = np.sort(want[row].astype(np.float64))[-2:]
            if top[1] - top[0] > TOL * (1 + abs(top[1])):
                assert got["tokens"][row][i] == int(np.argmax(want[row]))
                held += 1
    assert held >= 0.75 * SERVE[0] * SERVE[2]
    for rec in runs["mesh8"][1:]:
        assert rec[key]["tokens"] == got["tokens"]


@pytest.mark.parametrize("mode,mesh", ENGINES)
def test_engine_matches_reference_over_mesh(runs, mode, mesh):
    key = f"engine/{mode}/{mesh}"
    want, got = runs["ref"][key], runs["mesh8"][0][key]
    assert got["seq"] == want["seq"]
    compared = 0
    for i, toks in want["tokens"].items():
        rows = runs["ref_arrays"][f"{key}/rows{i}"]
        n = len(toks) if mode == "spec" else _upto(list(rows))
        assert got["tokens"][i][:n] == toks[:n], (i, got["tokens"][i], toks)
        # the first token's logits: before any stream can fork
        _close(runs["mesh8_arrays"][f"{key}/{i}"][0], rows[0])
        compared += n
    assert compared >= 0.8 * sum(len(t) for t in want["tokens"].values())
    for rec in runs["mesh8"][1:]:
        assert rec[key]["tokens"] == got["tokens"]
        assert rec[key]["total"] == got["total"]


def test_data_case_is_the_one_device_path(runs):
    """2 x 1 (the rows cut over 'data'): the static server, the slot
    engine and the paged engine against the one device."""
    one, a = runs["mesh1"], runs["mesh1_arrays"]
    for rec, arr in zip(runs["mesh2"], (runs["mesh2_arrays"], None)):
        assert rec["serve/2x1"]["tokens"] == one["serve/one"]["tokens"]
        for mode in ("slot", "paged"):
            got, want = rec[f"engine/{mode}/2x1"], one[f"engine/{mode}/one"]
            assert got["seq"] == want["seq"]
            assert got["tokens"] == want["tokens"]
        if arr is None:
            continue
        for i in range(SERVE[2]):
            _close(arr[f"serve/2x1/{i}"], a[f"serve/one/{i}"])
        for mode in ("slot", "paged"):
            for i in one[f"engine/{mode}/one"]["tokens"]:
                _close(arr[f"engine/{mode}/2x1/{i}"],
                       a[f"engine/{mode}/one/{i}"])
    assert runs["mesh2"][0]["serve/2x1"]["prefill"]["scale_max"] > 0


def test_one_by_one_mesh_is_the_one_device_path_bit_for_bit(runs):
    one, a = runs["mesh1"], runs["mesh1_arrays"]
    assert one["serve/1x1"]["tokens"] == one["serve/one"]["tokens"]
    for i in range(SERVE[2]):
        np.testing.assert_array_equal(a[f"serve/1x1/{i}"],
                                      a[f"serve/one/{i}"])
    for mode in ("slot", "paged"):
        got, want = one[f"engine/{mode}/1x1"], one[f"engine/{mode}/one"]
        assert got["seq"] == want["seq"] and got["tokens"] == want["tokens"]
        for i in want["tokens"]:
            np.testing.assert_array_equal(a[f"engine/{mode}/1x1/{i}"],
                                          a[f"engine/{mode}/one/{i}"])
        assert all(v == [0] for v in got["total"].values())
    assert one["serve/1x1"]["prefill"] == {}


def _float_cells(arch, mesh):
    cfg = C.smoke(C.get_config(arch))
    B, P, gen = SERVE
    abstract = Mesh(("data", "model"), MESHES[mesh])
    with use_context(plan_cache=PlanCache()):
        return (dryrun.serve_cell(cfg, abstract, "prefill", B, P)["cost"][
                    "by_collective"],
                dryrun.serve_cell(cfg, abstract, "decode", B,
                                  P + gen + 1)["cost"]["by_collective"])


def _quantized_steps(arch, mesh):
    """The pre-quantized static steps' collective bytes by kind on an
    abstract mesh (meta tensors): (prefill, a decode step)."""
    cfg = C.smoke(C.get_config(arch))
    B, P, gen = SERVE
    abstract = Mesh(("data", "model"), MESHES[mesh])
    art = make_serve_step(cfg, device="meta", mesh=abstract, quantized=True,
                          batch=B, max_len=P + gen + 1)
    params = art.shard_params(quantize_params(models.init(cfg,
                                                          device="meta")))
    state = art.init_state(B, P + gen + 1)
    meta = lambda shape: torch.zeros(shape, dtype=torch.int64,
                                     device="meta")
    out = []
    with use_context(quant_mode="int8", plan_cache=PlanCache()):
        with CollectiveCounter() as c:
            art.prefill_fn(params, state, art.rows({"tokens": meta((B, P))}))
        out.append(c.by_kind())
        rows = art.rows({"tokens": meta((B, 1))})["tokens"]
        with CollectiveCounter() as c:
            art.decode_raw(params, state, rows)
        out.append(c.by_kind())
    return out


def _less(kinds: dict, *drop) -> dict:
    return {k: v for k, v in kinds.items() if k not in drop}


@pytest.mark.parametrize("arch,mesh,quant", STATIC)
def test_step_bytes_reckoning(runs, arch, mesh, quant):
    """A dynamic int8 step's bytes are the float step's dry-run cell plus
    its ``scale_max``; a pre-quantized step's are the abstract mesh's, and
    but for the parameter gathers (int8 leaves) the float cell's."""
    pre, dec = _float_cells(arch, mesh)
    got = runs["mesh8"][0][f"serve/{arch}/{mesh}/{quant}"]
    steps = [got["prefill"]] + got["decode"]
    assert all(s["scale_max"] > 0 for s in steps)
    if quant == "dyn":
        assert _less(got["prefill"], "scale_max") == pre
        assert all(_less(s, "scale_max") == dec for s in got["decode"])
        return
    qpre, qdec = _quantized_steps(arch, mesh)
    assert got["prefill"] == qpre and all(s == qdec for s in got["decode"])
    assert _less(qpre, "scale_max", "all_gather") == _less(pre, "all_gather")
    assert _less(qdec, "scale_max", "all_gather") == _less(dec, "all_gather")


@pytest.mark.parametrize("shape,heads", [((2, 4), 1), ((1, 8), 4)])
def test_shard_state_lays_out_the_int8_pool(shape, heads):
    """``interop.shard_state`` of a whole int8 pool: the blocks over
    'data', the kv heads over 'model' with their scales (2 x 4), or the
    head_dim over 'model' and the scales whole (1 x 8: 4 kv heads)."""
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    L, nb, bs = cfg.n_layers, 8, 4
    gen = torch.Generator().manual_seed(SEED)
    pool = init_paged_kv_cache(2, nb, bs, 6, cfg.n_kv_heads, cfg.head_dim,
                               kv_dtype="int8", lead=(L,), device="cpu")
    pool = pool._replace(
        k=torch.randint(-127, 128, pool.k.shape, generator=gen,
                        dtype=torch.int8),
        k_scale=torch.rand(pool.k_scale.shape, generator=gen))
    mesh = Mesh(("data", "model"), shape, coords=(shape[0] - 1,
                                                  shape[1] - 1))
    got = interop.shard_state({"kv": pool}, None, mesh, cfg=cfg)["kv"]
    d, m = shape
    blocks = slice((d - 1) * nb // d, nb)
    assert tuple(got.k_scale.shape) == (L, nb // d, heads)
    assert torch.equal(got.k_scale,
                       pool.k_scale[:, blocks, cfg.n_kv_heads - heads:])
    if heads < cfg.n_kv_heads:
        assert torch.equal(got.k, pool.k[:, blocks, :, -heads:])
    else:
        dh = cfg.head_dim // m
        assert torch.equal(got.k, pool.k[:, blocks, :, :, -dh:])
