"""Expert parallelism (the MoE family over a mesh) on the CPU, against the
reference over the same mesh.

``moe_ffn``'s capacities depend on the EP degree D (``Cs = round8(cf T k
/ D)`` a destination, ``Ce`` over the ``D Cs`` rows received), so a 1 x 1
run is no yardstick: the reference runs on the same (data, model) mesh, in
a subprocess with 8 host devices (``tests/test_distributed.py``'s
harness). This process draws every input from numpy (seed ``SEED``) and
the reference's init of the olmoe-smoke model (``PRNGKey(SEED)``), writes
them to an .npz, then runs two jobs at once: the reference's subprocess
and 8 gloo ranks that import no JAX (with a 1-rank job beside them). Each
writes its results; the tests compare.

* ``moe_ffn`` on (4, 2), (2, 4) and (1, 8) meshes (D = 4, 2, 1 divide the
  smoke configs' 4 experts), each case's rows split over 'data': an
  olmoe-smoke layer at a capacity factor at which the reference drops
  assignments (``olmoe_drop``: its output differs from the no-drop
  ``moe_ref`` by far more than the tolerance, so equality pins the drop
  set), an arctic-smoke layer with a token mask, 8 experts top-4 (the
  combine's slot order differs from the k order) and int8 tables. y and
  the aux loss within TOL x (1 + |y|); the plain D-shard version
  (``moe_ep_plain``) against the reference and the ranks alike (the
  default capacity factor runs in the model-level checks below);
* the fault the mesh path repairs: the parent's per-DP-shard rule (one
  shard's capacities on a rank's tokens) misses the reference's output
  where capacity binds;
* olmoe-smoke's sharded train step (AdamW) from the reference's init: the
  loss within LOSS_TOL, one step's params leafwise within
  ``tests/test_torch_distributed.py``'s bound (1e-5 of a leaf's largest
  magnitude plus 1e-2 of the learning rate);
* the static server's tokens (``serve_batch``) against the reference's
  ``make_serve_step`` over the same mesh, each row up to its first
  near-tie in the reference (top-2 margin within 1e-4 of 1 + |top|,
  ``tests/test_torch_engine_mesh.py``'s rule);
* the paged engine under ``SimClock``: on (1, 8) against the reference's
  engine over (1, 8); on (4, 2) and (2, 4), where the reference's engine
  cannot run (its ``shard_map`` splits a one-request chunk's batch over
  'data'), against its engine at 1 x 1, whose capacities bind nowhere on
  this trace (at least 8 slots a destination, ``round8``), by the same
  rule; the admission sequence equal;
* each step's collective bytes equal to the dry run's
  (``launch.dryrun``), with ``all_to_all`` among them where D > 1;
* a 1 x 1 mesh is the one-device path bit for bit (static server, engine,
  train step); the ranks import no JAX.
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
from repro import serve as RS
from repro.compat import mesh_from_devices
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch.mesh import make_local_mesh as r_make_local_mesh
from repro.layers import moe as rmoe
from repro.quant.prequant import quantize_params as r_quantize_params
from repro.train.trainstep import make_train_step as r_make_train_step
from repro_torch import configs as C
from repro_torch import interop
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, free_port
from repro_torch.layers import moe
from repro_torch.quant.int8 import QuantizedLinear
from repro_torch.train import optimizer as opt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "olmoe-1b-7b"
SEED, BATCH, SEQ = 5, 8, 16
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}
TOL, LOSS_TOL, TIE = 1e-5, 1e-4, 1e-4
# the static server: batch, prompt, generated tokens
SB, SP, SGEN = 4, 8, 4
# moe_ffn's cases: the layer (a smoke config's, or dims of its own), the
# rows (8 x 8 tokens), top-k, capacity factor, int8 tables, a token mask
CASES = {
    "olmoe_drop": dict(arch="olmoe-1b-7b", top_k=2, cf=0.3),
    "arctic_mask": dict(arch="arctic-480b", top_k=2, cf=0.5, mask=True),
    "top4": dict(dims=(32, 48, 8), top_k=4, cf=1.0),
    "int8": dict(arch="olmoe-1b-7b", top_k=2, cf=1.25, int8=True),
}
TIMEOUT = 600  # seconds, each job

ENGINE_SRC = r'''
ENGINE = dict(num_slots=4, max_len=24, prompt_pad=8, kv_block_size=4,
              num_kv_blocks=24, prefill_chunk=4)


def engine_kw(pkg):
    """The paged engine's arguments and trace (the same seeds in both
    packages)."""
    return (dict(ENGINE, clock=pkg.SimClock(1e-3)),
            pkg.synthetic_trace(6, vocab_size=503, prompt_lens=[8, 5, 6],
                                max_new_tokens=[5, 3, 4], seed=2))


def ref_engine(RS, rcfg, mesh, rp):
    """The reference's paged engine over ``mesh``: its admissions, tokens
    and how many of each request's tokens precede its first near-tie."""
    kw, trace = engine_kw(RS)
    engine = RS.ServeEngine(rcfg, mesh, rp, **kw)
    log = []
    sample = engine._sample

    def recorded(row, st):
        tok = sample(row, st)
        top = np.sort(np.asarray(row[:rcfg.vocab_size], np.float64))[-2:]
        log.append((st.request.request_id, float(top[1] - top[0]),
                    float(top[1])))
        return tok

    engine._sample = recorded
    engine.run(trace)
    seq, toks = outcome(engine, trace)
    ids = {r.request_id: i for i, r in enumerate(trace)}
    sure = {}
    for rid, margin, top in log:
        sure.setdefault(ids[rid], []).append(margin > TIE * (1 + abs(top)))
    upto = {i: len(t) if all(sure.get(i, [])) else sure[i].index(False)
            for i, t in toks.items()}
    return {"seq": seq, "tokens": toks, "upto": upto}


def outcome(engine, trace):
    ids = {r.request_id: i for i, r in enumerate(trace)}
    seq = [[ids[st.request.request_id], st.slot, st.admitted_tick,
            st.first_token_tick, st.finished_tick, st.finish_reason]
           for st in engine.finished]
    toks = {ids[st.request.request_id]: [int(t) for t in st.tokens]
            for st in engine.finished}
    return seq, toks
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
from repro.data.synthetic import batch_for
from repro.layers import moe
from repro.parallel import sharding as rshd
from repro.quant.int8 import QuantizedLinear
from repro.train.servestep import make_serve_step
from repro.train.trainstep import make_train_step
from repro_torch import configs as C
from repro_torch import interop

work = sys.argv[1]
ARCH, SEED, BATCH, SEQ, MESHES, CASES, SERVE = {consts}
TIE = {tie}
{engine}
z = np.load(os.path.join(work, "inputs.npz"))
out, res = {{}}, {{}}


def table(case, name):
    if case + "/" + name + "/w_q" in z:
        return QuantizedLinear(w_q=jnp.asarray(z[case + "/" + name + "/w_q"]),
                               w_scale=jnp.asarray(
                                   z[case + "/" + name + "/w_scale"]),
                               bias=None)
    key = case + "/" + name
    return jnp.asarray(z[key]) if key in z else None


def layer(case):
    return moe.MoeParams(*(table(case, n) for n in
                           ("w_router", "w_in", "w_gate", "w_out")))


rcfg = RC.smoke(RC.get_config(ARCH))
cfg = C.smoke(C.get_config(ARCH))
state0 = np.load(os.path.join(work, "ref_state.npz"))
def restore(shapes):
    leaves, tdef = jax.tree.flatten(shapes)
    return jax.tree.unflatten(tdef, [jnp.asarray(state0[str(i)])
                                     for i in range(len(leaves))])


params = None
with use_context(plan_cache=PlanCache()):
    for mname, shape in MESHES.items():
        mesh = mesh_from_devices(np.array(jax.devices()).reshape(*shape),
                                 ("data", "model"))
        for case, c in CASES.items():
            p = layer(case)
            mask = z[case + "/mask"] if case + "/mask" in z else None
            fn = jax.jit(lambda p, x, m: moe.moe_ffn(
                p, x, mesh=mesh, top_k=c["top_k"], capacity_factor=c["cf"],
                token_mask=m))
            with mesh:
                y, aux = fn(p, jnp.asarray(z[case + "/x"]),
                            None if mask is None else jnp.asarray(mask))
            out[f"moe/{{mname}}/{{case}}/y"] = np.asarray(y)
            out[f"moe/{{mname}}/{{case}}/aux"] = np.asarray(aux)
        # the train step from the reference's init
        art = make_train_step(rcfg, mesh, global_batch=BATCH, seq_len=SEQ)
        with mesh:
            state = jax.device_put(restore(art.state_shapes),
                                   art.state_shardings)
            b = {{k: jnp.asarray(v) for k, v in
                 batch_for(rcfg, SEQ, BATCH, 0).items()}}
            state, m = art.step_fn(state, b)
            params = state["params"]
            res[f"train/{{mname}}"] = float(m["loss"])
            port = interop.params_from_jax(
                jax.tree.map(np.asarray, params), cfg, "cpu")
            for path, t in interop.tree_items(port):
                out[f"train/{{mname}}/{{path}}"] = t.numpy()
        # the static server: each step's logits
        B, P, gen = SERVE
        max_len = P + gen + 1
        rp = restore(art.state_shapes)["params"]
        sart = make_serve_step(rcfg, mesh, batch=B, max_len=max_len)
        tok_shard = jax.sharding.NamedSharding(mesh, rshd.batch_specs(
            {{"t": jax.ShapeDtypeStruct((B, 1), jnp.int32)}}, mesh)["t"])
        with mesh:
            st = jax.jit(lambda: RM.init_decode_state(rcfg, B, max_len),
                         out_shardings=sart.state_shardings)()
            logits, st = sart.prefill_fn(
                rp, st, {{"tokens": jnp.asarray(z["prompts"])}})
            toks = []
            for i in range(gen):
                out[f"serve/{{mname}}/logits{{i}}"] = np.asarray(logits,
                                                               np.float32)
                tok = jnp.argmax(logits[:, :rcfg.vocab_size], -1).astype(
                    jnp.int32)
                toks.append(np.asarray(tok))
                logits, st = sart.decode_fn(rp, st, jax.device_put(
                    tok[:, None], tok_shard))
        out[f"serve/{{mname}}/tokens"] = np.stack(toks, 1)
    # the paged engine over (1, 8)
    rp = restore(make_train_step(rcfg, mesh_from_devices(
        np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")),
        global_batch=BATCH, seq_len=SEQ).state_shapes)["params"]
    mesh = mesh_from_devices(np.array(jax.devices()).reshape(1, 8),
                             ("data", "model"))
    res["engine/1x8"] = ref_engine(RS, rcfg, mesh, rp)
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
from repro_torch import interop, models
from repro_torch import serve as TS
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter, data_parallel
from repro_torch.core.plancache import PlanCache
from repro_torch.data.synthetic import batch_for
from repro_torch.interop import shard_state, tree_items, tree_map
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import serve_batch
from repro_torch.layers import moe
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardPlan
from repro_torch.quant.int8 import QuantizedLinear
from repro_torch.quant.prequant import quantize_axes
from repro_torch.train.servestep import make_serve_step
from repro_torch.train.trainstep import make_train_step

mode, work = sys.argv[1], sys.argv[2]
ARCH, SEED, BATCH, SEQ, MESHES, CASES, SERVE = {consts}
{engine}
z = np.load(os.path.join(work, "inputs.npz"))
cfg = C.smoke(C.get_config(ARCH))
res, arrays = {{}}, {{}}


def table(case, name):
    if case + "/" + name + "/w_q" in z:
        return QuantizedLinear(
            w_q=torch.from_numpy(z[case + "/" + name + "/w_q"].copy()),
            w_scale=torch.from_numpy(z[case + "/" + name + "/w_scale"].copy()),
            bias=None)
    key = case + "/" + name
    return torch.from_numpy(z[key].copy()) if key in z else None


def moe_case(mesh, case, c):
    # the layer's blocks by the reference's rules, this rank's rows
    p = moe.MoeParams(*(table(case, n) for n in
                        ("w_router", "w_in", "w_gate", "w_out")))
    axes = {{"moe": moe.moe_axes(p.w_gate is not None)}}
    if isinstance(p.w_in, QuantizedLinear):
        axes = quantize_axes(axes)
    specs = shd.param_specs(axes, {{"moe": p}}, mesh)
    plan = ShardPlan(mesh, specs)
    spec_of = dict(tree_items(specs))
    blocks = shd.shard_tree({{"moe": p}}, specs, mesh)
    entry, size, _ = data_parallel(mesh)
    x = torch.from_numpy(z[case + "/x"].copy())
    mask = (torch.from_numpy(z[case + "/mask"].copy())
            if case + "/mask" in z else None)
    rows = lambda t: shd.shard_leaf(t, shd.P(entry), mesh)
    with use_context(mesh=mesh, shard=plan):
        lp = interop.tree_map_with_path(
            lambda path, t: plan.gather(t, spec_of[path], path), blocks)
        y, aux = moe.moe_ffn(lp["moe"], rows(x), top_k=c["top_k"],
                             capacity_factor=c["cf"],
                             token_mask=None if mask is None else rows(mask))
    return shd.gather_leaf(y, shd.P(entry), mesh), float(aux)


def _fill(shapes, s):
    it = iter([torch.from_numpy(s[p].copy()) for p, _ in tree_items(shapes)])
    return tree_map(lambda _: next(it), shapes)


def engine_run(params, mesh):
    kw, trace = engine_kw(TS)
    engine = TS.ServeEngine(cfg, params, mesh=mesh, **kw)
    engine.token_log = []
    engine.plan_warmup()
    engine.run(trace)
    seq, toks = outcome(engine, trace)
    return engine, {{"seq": seq, "tokens": toks,
                    "bytes": {{k: sorted(set(v)) for k, v in
                              engine.step_bytes.items()}},
                    "dispatches": dict(engine.dispatches)}}


with use_context(plan_cache=PlanCache()):
    full = None
    if mode == "mesh8":
        for mname, shape in MESHES.items():
            mesh = make_local_mesh(*shape, device="cpu")
            for case, c in CASES.items():
                y, aux = moe_case(mesh, case, c)
                arrays[f"moe/{{mname}}/{{case}}/y"] = y.numpy()
                res[f"moe/{{mname}}/{{case}}/aux"] = aux
            art = make_train_step(cfg, mesh=mesh, global_batch=BATCH,
                                  seq_len=SEQ)
            state = shard_state(_fill(art.state_shapes, np.load(
                os.path.join(work, "port_state.npz"))), tree_map(
                lambda s: s.spec, art.state_shardings), mesh)
            with CollectiveCounter() as cc:
                state, m = art.step_fn(state, batch_for(cfg, SEQ, BATCH, 0))
            res[f"train/{{mname}}"] = {{"loss": float(m["loss"]),
                                       "bytes": cc.by_kind()}}
            specs = tree_map(lambda s: s.spec, art.state_shardings)
            sp = dict(tree_items(specs["params"]))
            for path, t in tree_items(state["params"]):
                arrays[f"train/{{mname}}/{{path}}"] = shd.gather_leaf(
                    t.detach(), sp[path], mesh).numpy()
            whole = _fill(models.init(cfg, device="meta"), np.load(
                os.path.join(work, "port_params.npz")))
            blocks = make_serve_step(cfg, device="cpu",
                                     mesh=mesh).shard_params(whole)
            B, P, gen = SERVE
            rec = {{}}
            toks = serve_batch(cfg, blocks, torch.from_numpy(
                z["prompts"].copy()).long(), gen_len=gen,
                max_len=P + gen + 1, mesh=mesh, record=rec)
            res[f"serve/{{mname}}"] = {{
                "tokens": toks.tolist(), "prefill_bytes": rec["prefill_bytes"],
                "decode_bytes": sorted(set(rec["decode_bytes"]))}}
            res[f"engine/{{mname}}"] = engine_run(whole, mesh)[1]
    else:  # mesh1: a 1 x 1 mesh against no mesh, bit for bit
        mesh = make_local_mesh(1, 1, device="cpu")
        whole = _fill(models.init(cfg, device="meta"), np.load(
            os.path.join(work, "port_params.npz")))
        B, P, gen = SERVE
        prompts = torch.from_numpy(z["prompts"].copy()).long()
        recs = []
        for m_ in (mesh, None):
            rec = {{}}
            toks = serve_batch(cfg, whole, prompts, gen_len=gen,
                               max_len=P + gen + 1, mesh=m_, record=rec)
            recs.append((toks, rec["logits"]))
        res["serve_same"] = torch.equal(recs[0][0], recs[1][0]) and all(
            torch.equal(a, b) for a, b in zip(recs[0][1], recs[1][1]))
        runs = [engine_run(whole, m_) for m_ in (mesh, None)]
        res["engine_same"] = (
            runs[0][1]["tokens"] == runs[1][1]["tokens"]
            and [t[1:] for t in runs[0][0].token_log]
            == [t[1:] for t in runs[1][0].token_log])
        states = []
        for m_ in (mesh, None):
            art = make_train_step(cfg, mesh=m_, global_batch=BATCH,
                                  seq_len=SEQ, device="cpu")
            state = _fill(art.state_shapes, np.load(
                os.path.join(work, "port_state.npz")))
            state, m = art.step_fn(state, batch_for(cfg, SEQ, BATCH, 0))
            states.append((float(m["loss"]), state["params"]))
        res["train_same"] = states[0][0] == states[1][0] and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                tree_items(states[0][1]), tree_items(states[1][1])))
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
rank = dist.get_rank()
with open(os.path.join(work, f"{{mode}}_rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
if rank == 0:
    np.savez(os.path.join(work, f"{{mode}}_rank0.npz"), **arrays)
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


def _case_params(rng, c) -> tuple:
    """(the reference's MoeParams, its tree as numpy arrays by field)."""
    if "arch" in c:
        cfg = RC.smoke(RC.get_config(c["arch"]))
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        gated = cfg.gated_mlp
    else:
        (d, f, E), gated = c["dims"], True
    w = lambda shape, scale: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    p = rmoe.MoeParams(
        w_router=jnp.asarray(w((d, E), 1.0)),
        w_in=jnp.asarray(w((E, d, f), d ** -0.5)),
        w_gate=jnp.asarray(w((E, d, f), d ** -0.5)) if gated else None,
        w_out=jnp.asarray(w((E, f, d), f ** -0.5)))
    if c.get("int8"):
        p = r_quantize_params(p)
    return p, d


def _inputs(work: str) -> dict:
    """Every input, written to ``inputs.npz`` (the layers' tables, the
    rows, the masks, the prompts) and the reference's init of the model
    (the reference's state by leaf order, the port's state and params)."""
    rng = np.random.default_rng(SEED)
    arrays, layers = {}, {}
    for case, c in CASES.items():
        p, d = _case_params(rng, c)
        layers[case] = p
        for name in ("w_router", "w_in", "w_gate", "w_out"):
            t = getattr(p, name)
            if t is None:
                continue
            if hasattr(t, "w_q"):
                arrays[f"{case}/{name}/w_q"] = np.asarray(t.w_q)
                arrays[f"{case}/{name}/w_scale"] = np.asarray(t.w_scale)
            else:
                arrays[f"{case}/{name}"] = np.asarray(t)
        arrays[f"{case}/x"] = rng.standard_normal((8, 8, d)).astype(
            np.float32)
        if c.get("mask"):
            arrays[f"{case}/mask"] = rng.random((8, 8)) < 0.7
    rcfg, cfg = RC.smoke(RC.get_config(ARCH)), C.smoke(C.get_config(ARCH))
    arrays["prompts"] = rng.integers(0, rcfg.vocab_size,
                                     size=(SB, SP)).astype(np.int32)
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    mesh1 = mesh_from_devices(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    art = r_make_train_step(rcfg, mesh1, global_batch=BATCH, seq_len=SEQ)
    with mesh1:
        tree = jax.tree.map(np.asarray, art.init_fn(
            jax.random.PRNGKey(SEED)))
    np.savez(os.path.join(work, "ref_state.npz"),
             **{str(i): a for i, a in enumerate(jax.tree.leaves(tree))})
    state = interop.state_from_jax(tree, cfg, "cpu")
    np.savez(os.path.join(work, "port_state.npz"),
             **{p: t.numpy() for p, t in tree_items(state)})
    np.savez(os.path.join(work, "port_params.npz"),
             **{p: t.numpy() for p, t in tree_items(state["params"])})
    return {"arrays": arrays, "layers": layers, "init": state,
            "ref_params": jax.tree.map(jnp.asarray, tree["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ep"))
    with r_use_context(plan_cache=RPlanCache()):
        inputs = _inputs(work)
    consts = (ARCH, SEED, BATCH, SEQ, MESHES, CASES, (SB, SP, SGEN))
    ref_path, prog = (os.path.join(work, n) for n in ("ref.py", "rank.py"))
    with open(ref_path, "w") as f:
        f.write(REF_PROG.format(consts=consts, engine=ENGINE_SRC, tie=TIE))
    with open(prog, "w") as f:
        f.write(PROG.format(consts=consts, engine=ENGINE_SRC))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    ref = subprocess.Popen([sys.executable, ref_path, work], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    jobs = _spawn(prog, "mesh8", 8, work) + _spawn(prog, "mesh1", 1, work)
    try:  # meanwhile the reference's engine at 1 x 1, here
        with r_use_context(plan_cache=RPlanCache()):
            one = ref_engine(RS, RC.smoke(RC.get_config(ARCH)),
                             r_make_local_mesh(), inputs["ref_params"])
    finally:
        _wait(jobs + [ref], TIMEOUT)
    load = lambda name: json.load(open(os.path.join(work, name + ".json")))
    return {"inputs": inputs, "ref": dict(np.load(os.path.join(work,
                                                              "ref.npz"))),
            "ref_json": {**load("ref"),
                         "engine/1x1": json.loads(json.dumps(one))},
            "mesh8": [load(f"mesh8_rank{r}") for r in range(8)],
            "arrays": dict(np.load(os.path.join(work, "mesh8_rank0.npz"))),
            "mesh1": load("mesh1_rank0")}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def _port_layer(inputs, case) -> moe.MoeParams:
    a = inputs["arrays"]

    def table(name):
        if f"{case}/{name}/w_q" in a:
            return QuantizedLinear(
                w_q=torch.from_numpy(a[f"{case}/{name}/w_q"].copy()),
                w_scale=torch.from_numpy(a[f"{case}/{name}/w_scale"].copy()),
                bias=None)
        key = f"{case}/{name}"
        return torch.from_numpy(a[key].copy()) if key in a else None

    return moe.MoeParams(*(table(n) for n in ("w_router", "w_in", "w_gate",
                                              "w_out")))


MOE_CASES = [(m, c) for m in MESHES for c in CASES]


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for r in runs["mesh8"])
    assert not runs["mesh1"]["jax_imported"]


@pytest.mark.parametrize("mesh,case", MOE_CASES)
def test_moe_ffn_over_mesh_matches_reference(runs, mesh, case):
    want = runs["ref"][f"moe/{mesh}/{case}/y"]
    got = runs["arrays"][f"moe/{mesh}/{case}/y"]
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    aux = float(runs["ref"][f"moe/{mesh}/{case}/aux"])
    for rec in runs["mesh8"]:  # the DP mean: every rank's the same
        assert abs(rec[f"moe/{mesh}/{case}/aux"] - aux) <= TOL * (1 + aux)


@pytest.mark.parametrize("mesh,case", MOE_CASES)
def test_plain_shard_version_matches_both(runs, mesh, case):
    c, D = CASES[case], MESHES[mesh][0]
    p = _port_layer(runs["inputs"], case)
    a = runs["inputs"]["arrays"]
    mask = a.get(f"{case}/mask")
    y, aux = moe.moe_ep_plain(
        p, torch.from_numpy(a[f"{case}/x"]), D, top_k=c["top_k"],
        capacity_factor=c["cf"],
        token_mask=None if mask is None else torch.from_numpy(mask))
    assert _rel(y, runs["ref"][f"moe/{mesh}/{case}/y"]) <= TOL
    assert _rel(y, runs["arrays"][f"moe/{mesh}/{case}/y"]) <= TOL
    assert _rel(float(aux), runs["ref"][f"moe/{mesh}/{case}/aux"]) <= TOL


def test_drop_case_drops_and_mask_case_masks(runs):
    """The reference's output at the small capacity factor is not the
    no-drop layer's (assignments were dropped), and at a mask dead rows
    return zeros."""
    p = runs["inputs"]["layers"]["olmoe_drop"]
    x = runs["inputs"]["arrays"]["olmoe_drop/x"]
    dense = np.asarray(rmoe.moe_ref(p, jnp.asarray(x), top_k=2))
    for mesh in MESHES:
        assert _rel(runs["ref"][f"moe/{mesh}/olmoe_drop/y"], dense) > 1e-2
    mask = runs["inputs"]["arrays"]["arctic_mask/mask"]
    for mesh in MESHES:
        assert not np.any(runs["arrays"][f"moe/{mesh}/arctic_mask/y"][~mask])


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_parent_per_shard_capacity_rule_differs(runs, mesh):
    """The parent's sharded step reckoned a rank's MoE capacity as one
    shard's over its own tokens (``Cs = round8(cf T_l k)``, ``Ce`` over
    all E experts): where capacity binds it drops other assignments than
    the reference over the mesh, which the EP path matches."""
    c, D = CASES["olmoe_drop"], MESHES[mesh][0]
    p = _port_layer(runs["inputs"], "olmoe_drop")
    x = torch.from_numpy(runs["inputs"]["arrays"]["olmoe_drop/x"])
    parent = torch.cat([moe.moe_ffn(p, xs, top_k=c["top_k"],
                                    capacity_factor=c["cf"])[0]
                        for xs in x.chunk(D)])
    want = runs["ref"][f"moe/{mesh}/olmoe_drop/y"]
    assert _rel(parent, want) > 100 * TOL
    assert _rel(runs["arrays"][f"moe/{mesh}/olmoe_drop/y"], want) <= TOL


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_over_mesh_matches_reference(runs, mesh):
    loss = runs["ref_json"][f"train/{mesh}"]
    for rec in runs["mesh8"]:  # the DP mean on every rank
        assert abs(rec[f"train/{mesh}"]["loss"] - loss) <= LOSS_TOL
    lr = float(opt_lib.schedule(opt_lib.OptConfig(), torch.tensor(0)))
    seen = 0
    for path, t in tree_items(runs["inputs"]["init"]["params"]):
        want = runs["ref"][f"train/{mesh}/{path}"]
        got = runs["arrays"][f"train/{mesh}/{path}"]
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-2 * lr,
            err_msg=path)
        seen += 1
    assert seen > 0


def _held(toks, logits_seq) -> tuple[int, int]:
    """(positions compared, positions equal): each row up to its first
    near-tie in the reference's logits."""
    held = same = 0
    for row in range(len(toks)):
        for t, lg in enumerate(logits_seq):
            top = np.sort(lg[row].astype(np.float64))[-2:]
            if not top[1] - top[0] > TIE * (1 + abs(top[1])):
                break
            held += 1
            same += int(toks[row][t] == int(np.argmax(lg[row])))
    return held, same


@pytest.mark.parametrize("mesh", list(MESHES))
def test_static_server_over_mesh_matches_reference(runs, mesh):
    vocab = C.smoke(C.get_config(ARCH)).vocab_size
    logits = [runs["ref"][f"serve/{mesh}/logits{i}"][:, :vocab]
              for i in range(SGEN)]
    toks = runs["mesh8"][0][f"serve/{mesh}"]["tokens"]
    held, same = _held(toks, logits)
    assert same == held and held >= 0.75 * SB * SGEN
    for rec in runs["mesh8"][1:]:
        assert rec[f"serve/{mesh}"]["tokens"] == toks


@pytest.mark.parametrize("mesh", list(MESHES))
def test_paged_engine_over_mesh_matches_reference(runs, mesh):
    want = runs["ref_json"]["engine/" + ("1x8" if mesh == "1x8" else "1x1")]
    got = runs["mesh8"][0][f"engine/{mesh}"]
    assert got["seq"] == want["seq"]
    compared = 0
    for i, toks in want["tokens"].items():
        n = want["upto"][i]
        assert got["tokens"][i][:n] == toks[:n], (i, got["tokens"][i], toks)
        compared += n
    assert compared >= 0.9 * sum(len(t) for t in want["tokens"].values())
    for rec in runs["mesh8"][1:]:
        assert rec[f"engine/{mesh}"] == got


_CELLS = {}


def _cells(mesh):
    if mesh not in _CELLS:
        cfg = C.smoke(C.get_config(ARCH))
        kw = ENGINE
        abstract = Mesh(("data", "model"), MESHES[mesh])
        with use_context(plan_cache=PlanCache()):
            _CELLS[mesh] = {
                "train": dryrun.train_cell(cfg, abstract, BATCH, SEQ),
                "prefill": dryrun.serve_cell(cfg, abstract, "prefill", SB,
                                             SP),
                "decode": dryrun.serve_cell(cfg, abstract, "decode", SB,
                                            SP + SGEN + 1),
                "engine": dryrun.engine_cells(
                    cfg, abstract, num_slots=kw["num_slots"],
                    max_len=kw["max_len"], prompt_pad=kw["prompt_pad"],
                    kv_block_size=kw["kv_block_size"],
                    num_kv_blocks=kw["num_kv_blocks"],
                    prefill_chunk=kw["prefill_chunk"])}
    return _CELLS[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_collective_bytes_equal_dryrun(runs, mesh):
    cells = _cells(mesh)
    ep = MESHES[mesh][0] > 1
    for rec in runs["mesh8"]:
        train = rec[f"train/{mesh}"]["bytes"]
        assert train == cells["train"]["cost"]["by_collective"]
        assert ("all_to_all" in train) == ep
        serve = rec[f"serve/{mesh}"]
        assert serve["prefill_bytes"] == \
            cells["prefill"]["cost"]["collective_bytes_per_device"]
        assert serve["decode_bytes"] == [
            cells["decode"]["cost"]["collective_bytes_per_device"]]
        got = rec[f"engine/{mesh}"]["bytes"]
        assert got and set(got) <= set(cells["engine"])
        for tag, seen in got.items():
            cell = cells["engine"][tag]
            assert seen == [cell["collective_bytes_per_device"]], tag
            assert ("all_to_all" in cell["by_collective"]) == ep


def test_one_by_one_mesh_is_the_one_device_path(runs):
    rec = runs["mesh1"]
    assert rec["serve_same"] and rec["engine_same"] and rec["train_same"]


def test_launcher_serves_moe_int8_over_data(tmp_path):
    """``torchrun ... launch.serve --arch olmoe-1b-7b --mesh 2x1 --quantize
    int8``: int8 expert tables over 'data' (the ranks load one at a time,
    the warm-up plans the quantized tree's blocks): both ranks serve the
    same tokens with zero lazy solves, and the one-device server whose MoE
    layers run ``moe_ep_plain`` over the same 2 shards (the mesh's
    semantics: each shard's capacities and its router's W8A8 scale)
    serves the same tokens, every step's logits within 1e-4 of 1 + |logit|
    (the attention's, the dense projections' and the unembed's W8A8 scales
    span both ranks' rows)."""
    from repro_torch.launch import serve

    prefix = str(tmp_path / "q")
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--plan-cache", "",
            "--quantize", "int8"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(free_port()), "-m", "repro_torch.launch.serve", *args,
         "--mesh", "2x1", "--record-out", prefix],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[mesh] 2x1" in run.stdout and "lazy_solves=0" in run.stdout
    recs = [torch.load(f"{prefix}.rank{r}.pt", weights_only=False)
            for r in range(2)]
    assert torch.equal(recs[0]["tokens"], recs[1]["tokens"])
    assert recs[0]["prefill_by_kind"]["all_to_all"] > 0
    assert recs[0]["prefill_by_kind"]["scale_max"] > 0
    saved = moe.moe_ffn
    moe.moe_ffn = lambda p, x, **kw: moe.moe_ep_plain(p, x, 2, **kw)
    try:
        with use_context(plan_cache=PlanCache()):
            serve.main(args + ["--record-out", str(tmp_path / "one")])
    finally:
        moe.moe_ffn = saved
    one = torch.load(str(tmp_path / "one.rank0.pt"), weights_only=False)
    assert torch.equal(recs[0]["tokens"], one["tokens"])
    for step, want in enumerate(one["logits"]):
        got = torch.cat([rec["logits"][step] for rec in recs])
        assert _rel(got, want) <= TIE, step
