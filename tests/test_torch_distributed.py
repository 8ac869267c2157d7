"""The port's distribution on the CPU: 8 ``gloo`` ranks as a 4 x 2 mesh,
the counterpart of the reference's 8-device test (tests/test_distributed.py
section 4).

One module fixture writes the reference's init of internlm2-20b --smoke
(``interop.state_from_jax``) to an .npz and runs the reference's 1 x 1
``make_train_step`` on it, then spawns three jobs of ranks that import no
JAX (``torch.distributed`` over loopback, torchrun's environment):

* 8 ranks, a 4 x 2 (data, model) mesh: the output-stationary GEMM and the
  K-sharded foil against a local matmul with their collective bytes; the
  pipeline, 4 stages over 'data', against the sequential product; two
  sharded train steps (AdamW) from the .npz with each step's collective
  bytes, the first step's gradients and the parameters after two, gathered;
  the same with Adafactor (its factored moments resharded); one step of
  the rwkv, hybrid, encoder-decoder and vision families and of a dense
  config with remat ("full" and "dots") and 2 microbatches; a
  checkpoint;
* 2 ranks (2 x 1) and 1 rank (1 x 1): the checkpoint restored onto their
  mesh and gathered back; the 1 x 1 job also runs two steps of the mesh
  step, held bit for bit to the one-device step (mesh=None).

Tolerances, stated beforehand: the GEMMs 1e-4 and the pipeline 1e-5 (f32,
the reference's bounds); the 4 x 2 loss within 5e-3 of the reference's 1 x
1 (its own bound) and within 1e-4 of the port's 1 x 1; the gradients within
1e-4 of each leaf's largest magnitude (the DP mean sums the shards in
another order); the parameters after two steps within
``tests/test_torch_train.py``'s bound for a parameter leaf, 1e-5 of its
largest magnitude plus 1e-2 of the sum of the learning rates (Adam divides
each element by its own RMS, so summation order alone moves a small
element by up to a step). The dry run's reckoned collective bytes for the
step equal the counter's measured bytes exactly; the checkpoint round trip
is exact.
"""
import dataclasses
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
from repro.compat import mesh_from_devices
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro import models as RM
from repro.data.synthetic import batch_for as r_batch_for
from repro.launch.serve import serve_batch as r_serve_batch
from repro.train.servestep import make_serve_step as r_make_serve_step
from repro.train.trainstep import make_train_step as r_make_train_step
from repro_torch import configs as C
from repro_torch import interop
from repro_torch.data.synthetic import batch_for
from repro_torch.core import gemm
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, free_port
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainstep import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SEQ, BATCH, STEPS, SEED = "internlm2-20b", 32, 8, 2, 7
ADAFACTOR = dict(name="adafactor", b1=0.0, state_dtype="float32")
# the other families whose forwards gather a layer slice at a time (the
# MoE family's capacity and aux loss are reckoned per DP shard, so its
# sharded step is not the one-device step), and a dense config with remat,
# "full" and "dots" (the recompute gathers again, inside the backward;
# "dots" takes the products' outputs back, not their operands) and 2
# microbatches
# (the unstacked leaves' gradients reduced once over both): (name, arch,
# the smoke config's overrides)
FAMILIES = (("rwkv6-3b", "rwkv6-3b", {}), ("zamba2-1.2b", "zamba2-1.2b", {}),
            ("whisper-base", "whisper-base", {}),
            ("llama-3.2-vision-11b", "llama-3.2-vision-11b", {}),
            ("qwen1.5-4b remat mb2", "qwen1.5-4b",
             {"remat": True, "microbatches": 2}),
            ("qwen1.5-4b dots mb2", "qwen1.5-4b",
             {"remat": True, "remat_policy": "dots", "microbatches": 2}))
FIXTURE_TIMEOUT = 300  # seconds, for all three jobs
# the static server's parity runs (tensor parallelism): archs, batch,
# prompt, generated tokens
SERVE = (("qwen1.5-4b", "internlm2-20b"), 4, 8, 4)

PROG = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs as C
from repro_torch import interop, models
from repro_torch.core import gemm
from repro_torch.core.context import use_context
from repro_torch.core.distributed import (CollectiveCounter, k_sharded_gemm,
                                          output_stationary_gemm)
from repro_torch.core.gemm import balanced_gemm
from repro_torch.layers import common as cm
from repro_torch.layers.attention import KVCache
from repro_torch.launch.serve import serve_batch
from repro_torch.parallel.fsdp import ShardPlan
from repro_torch.train.servestep import make_serve_step
from repro_torch.data.synthetic import batch_for
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.interop import shard_state, tree_items, tree_map
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainstep import make_train_step

mode, work = sys.argv[1], sys.argv[2]
ARCH, SEQ, BATCH, STEPS, SEED = {consts}
ADAFACTOR = {adafactor}
FAMILIES = {families}
SERVE_ARCHS, SB, SP, SGEN = {serve}
data, model = {{"mesh8": (4, 2), "restore2": (2, 1), "mesh1": (1, 1)}}[mode]
mesh = make_local_mesh(data, model, device="cpu")
cfg = C.smoke(C.get_config(ARCH))
res, arrays = {{}}, {{}}
saved = np.load(os.path.join(work, "init.npz"))


def specs_of(art):
    return tree_map(lambda s: s.spec, art.state_shardings)


def from_npz(shapes, prefix=""):
    it = iter([saved[prefix + p] for p, _ in tree_items(shapes)])
    return tree_map(lambda _: torch.from_numpy(next(it).copy()), shapes)


def gathered(tree, specs, prefix):
    sp = dict(tree_items(specs))
    for p, t in tree_items(tree):
        arrays[prefix + p] = shd.gather_leaf(t, sp[p], mesh).detach().numpy()


def train(opt_cfg, tag):
    grads = {{}}

    def hook(g):
        if not grads:
            grads.update({{p: t.clone() for p, t in tree_items(g)}})

    art = make_train_step(cfg, opt_cfg, mesh=mesh, global_batch=BATCH,
                          seq_len=SEQ, grads_hook=hook)
    if opt_cfg is None:
        full = from_npz(art.state_shapes)
    else:  # the npz holds AdamW's state: the params and a fresh one
        params = from_npz(art.state_shapes["params"], "params/")
        full = {{"params": params, "step": torch.zeros((), dtype=torch.int32),
                "opt": opt_lib.make_optimizer(opt_cfg).init(params)}}
    state = shard_state(full, specs_of(art), mesh)
    losses, nbytes, flops = [], [], []
    count = lambda key, plan: flops.append(2 * key[1] * key[2] * key[3])
    for step in range(STEPS):
        if step == 0:
            gemm.add_dispatch_listener(count)
        with CollectiveCounter() as c:
            state, m = art.step_fn(state, batch_for(cfg, SEQ, BATCH, step))
        gemm.remove_dispatch_listener(count)
        losses.append(float(m["loss"]))
        nbytes.append(c.by_kind())
    res[tag] = {{"losses": losses, "bytes": nbytes, "gemm_flops": sum(flops)}}
    gathered(grads, specs_of(art)["params"], tag + "/grad/")
    gathered(state, specs_of(art), tag + "/state/")
    return art, state


def rel_err(got, want):
    want = torch.as_tensor(want)
    return float(((got - want).abs() / (1 + want.abs())).max())


def serve(arch, tag):
    # the static server over mesh against the reference's 1 x 1 run:
    # tokens, the prefill's and each step's logits on this rank's rows, the
    # collective bytes, the decode state's local shapes, and one decode
    # step from the reference's prefilled state handed over by shard_state
    scfg = C.smoke(C.get_config(arch))
    z = np.load(os.path.join(work, f"serve_{{arch}}.npz"))
    shapes = models.init(scfg, device="meta")
    it = iter([torch.from_numpy(z["params/" + p].copy())
               for p, _ in tree_items(shapes)])
    whole = tree_map(lambda _: next(it), shapes)
    max_len = SP + SGEN + 1
    art = make_serve_step(scfg, device="cpu", mesh=mesh, batch=SB,
                          max_len=max_len)
    params = art.shard_params(whole)
    prompts = torch.from_numpy(z["prompts"]).long()
    rec = {{}}
    gen = serve_batch(scfg, params, prompts, gen_len=SGEN, max_len=max_len,
                      mesh=mesh, record=rec)
    rows = shd.batch_specs({{"t": prompts}}, mesh)["t"]
    want = [shd.shard_leaf(torch.from_numpy(z[f"logits{{i}}"]), rows, mesh)
            for i in range(SGEN)]
    out = {{"tokens": gen.tolist(), "prefill_bytes": rec["prefill_bytes"],
           "decode_bytes": rec["decode_bytes"],
           "logit_err": max(rel_err(g, w) for g, w in
                            zip(rec["logits"], want)),
           "state_shapes": {{p: list(t.shape) for p, t in tree_items(
               art.init_state(SB, max_len))}}}}
    full = {{"kv": KVCache(*(torch.from_numpy(z["state/" + f].copy())
                            for f in ("k", "v", "length")))}}
    state = interop.shard_state(full, None, mesh, cfg=scfg)
    tok = art.rows({{"t": torch.from_numpy(z["tokens"][:, :1]).long()}})["t"]
    logits = art.decode_fn(params, state, tok)
    out["handed_err"] = rel_err(logits, want[1])
    if mesh.size == 1:  # and the one-device server, bit for bit
        plain = {{}}
        serve_batch(scfg, whole, prompts, gen_len=SGEN, max_len=max_len,
                    record=plain)
        out["plain_diff"] = max(float((a - b).abs().max()) for a, b in
                                zip(rec["logits"], plain["logits"]))
    res[tag] = out


def embed_check(tag):
    # the vocab-parallel lookup of a (512, 16) table split over 'model'
    # against the whole table's rows; ids outside [0, 512) give zeros
    table = torch.randn((512, 16), generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 5, 255, 256, 502, 503, 511], [512, 700, -1, 7,
                                                         63, 64, 448]])
    plan = ShardPlan(mesh, {{"embed": shd.P("model", None)}})
    with use_context(mesh=mesh, shard=plan):
        block = plan.gather(shd.shard_leaf(table, shd.P("model"), mesh),
                            shd.P("model", None), "embed")
        with CollectiveCounter() as c:
            got = cm.embed_lookup(block, ids)
    ok = (ids >= 0) & (ids < 512)
    want = torch.where(ok[..., None], table[ids.clamp(0, 511)], 0.0)
    res[tag] = {{"err": float((got - want).abs().max()),
                "block_rows": block.shape[0], "bytes": c.by_kind()}}


if mode == "mesh8":
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=(64, 96)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(96, 32)), dtype=torch.float32)
    want = a @ b
    with CollectiveCounter() as c:
        blk = output_stationary_gemm(a, b, mesh)
    res["os_bytes"] = c.total
    rows, cols = mesh.axis_index("data") * 16, mesh.axis_index("model") * 16
    res["os_err"] = float((blk - want[rows:rows + 16, cols:cols + 16])
                          .abs().max())
    whole = shd.gather_leaf(blk, shd.P("data", "model"), mesh)
    res["os_whole_err"] = float((whole - want).abs().max())
    with CollectiveCounter() as c:
        got = k_sharded_gemm(a, b, mesh, k_axis="model")
    res["k_bytes"] = c.total
    res["k_err"] = float((got - want).abs().max())
    S, M, B, D = 4, 8, 2, 16
    ws = torch.tensor(rng.normal(size=(S, D, D)) * 0.3, dtype=torch.float32)
    xs = torch.tensor(rng.normal(size=(M, B, D)), dtype=torch.float32)
    stage = lambda w, x, s: torch.tanh(balanced_gemm(x, w))
    got = pipeline_apply(stage, ws[mesh.axis_index("data")][None], xs, mesh,
                         axis="data")
    ref = xs
    for s in range(S):
        ref = torch.tanh(ref @ ws[s])
    res["pp_err"] = float((got - ref).abs().max())
    art, state = train(None, "adamw")
    train(opt_lib.OptConfig(**ADAFACTOR), "adafactor")
    for name, arch, over in FAMILIES:  # one step of each sharded step
        fcfg = dataclasses.replace(C.smoke(C.get_config(arch)), **over)
        fart = make_train_step(fcfg, mesh=mesh, global_batch=BATCH,
                               seq_len=SEQ)
        fstate, m = fart.step_fn(fart.init_fn(0),
                                 batch_for(fcfg, SEQ, BATCH, 0))
        res["family/" + name] = [float(m["loss"]), fart.microbatches]
        gathered(fstate["params"], specs_of(fart)["params"],
                 "family/" + name + "/")
    ckpt_lib.save(os.path.join(work, "ckpt"), state, STEPS,
                  shardings=art.state_shardings)
    # tensor parallelism over the same 8 ranks: the static server at 4 x 2
    # and 2 x 4, the train step at 2 x 4 (GQA: 2 kv heads on 4) and 1 x 8
    # (4 heads on 8: 'seq'), the vocab-parallel lookup split 2, 4, 8 ways
    for arch in SERVE_ARCHS:
        serve(arch, "serve4x2/" + arch)
    embed_check("embed4x2")
    for shape in ((2, 4), (1, 8)):
        mesh = make_local_mesh(*shape, device="cpu")
        name = "x".join(map(str, shape))
        train(None, "tp" + name)
        embed_check("embed" + name)
        if shape == (2, 4):
            for arch in SERVE_ARCHS:
                serve(arch, "serve2x4/" + arch)
else:
    art = make_train_step(cfg, mesh=mesh, global_batch=BATCH, seq_len=SEQ)
    step = ckpt_lib.latest_step(os.path.join(work, "ckpt"))
    state = ckpt_lib.restore(os.path.join(work, "ckpt"), step,
                             art.state_shapes, device="cpu",
                             shardings=art.state_shardings)
    res["restored_step"] = step
    gathered(state, specs_of(art), "restored/")
    if mode == "mesh1":
        train(None, "adamw")
        plain = make_train_step(cfg, global_batch=BATCH, seq_len=SEQ,
                                device="cpu")
        st = from_npz(plain.state_shapes)
        for step in range(STEPS):
            st, _ = plain.step_fn(st, batch_for(cfg, SEQ, BATCH, step))
        for p, t in tree_items(st):
            arrays["plain/state/" + p] = t.detach().numpy()
        # the static server on the 1 x 1 mesh: the one-device tokens
        for arch in SERVE_ARCHS:
            serve(arch, "serve1x1/" + arch)
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
out = os.path.join(work, f"{{mode}}_rank{{mesh.rank}}")
with open(out + ".json", "w") as f:
    json.dump(res, f)
if mesh.rank == 0:
    np.savez(out + ".npz", **arrays)
dist.destroy_process_group()
"""



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


def _reference(cfg):
    """The reference's 1 x 1 train step from PRNGKey(SEED): the state before
    it (numpy) and its first loss."""
    mesh1 = mesh_from_devices(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    art = r_make_train_step(cfg, mesh1)
    with mesh1:
        s = art.init_fn(jax.random.PRNGKey(SEED))
        tree = jax.tree.map(np.asarray, s)
        b = {k: jnp.asarray(v) for k, v in r_batch_for(cfg, SEQ, BATCH,
                                                       0).items()}
        _, m = art.step_fn(s, b)
    return tree, float(m["loss"])


def _port_one_device(cfg, init, opt_cfg=None):
    """The port's one-device step from ``init``, STEPS steps: the losses,
    the first step's gradients and GEMM operations (2 M K N over the
    dispatches), and the state after."""
    grads, flops = {}, []

    def hook(g):
        if not grads:
            grads.update({p: t.clone() for p, t in tree_items(g)})

    art = make_train_step(cfg, opt_cfg, global_batch=BATCH, seq_len=SEQ,
                          device="cpu", grads_hook=hook)
    state = interop.tree_map(lambda t: t.clone(), init)
    if opt_cfg is not None:
        state["opt"] = opt_lib.make_optimizer(opt_cfg).init(state["params"])
    losses = []
    count = lambda key, plan: flops.append(2 * key[1] * key[2] * key[3])
    for step in range(STEPS):
        if step == 0:
            gemm.add_dispatch_listener(count)
        try:
            state, m = art.step_fn(state, batch_for(cfg, SEQ, BATCH, step))
        finally:
            gemm.remove_dispatch_listener(count)
        losses.append(float(m["loss"]))
    return {"losses": losses, "grads": grads, "gemm_flops": sum(flops),
            "state": {p: t.detach() for p, t in tree_items(state)}}


def _reference_serve(arch: str, work: str) -> dict:
    """The reference's static server at 1 x 1 on ``arch``'s smoke config
    from PRNGKey(SEED): its tokens (``serve_batch``) and, through its
    ``make_serve_step``, the prefill's and each decode step's logits and
    the decode state after the prefill, written to an .npz with the
    weights (the port's tree) and the prompts."""
    _, B, P, gen = SERVE
    rcfg, cfg = RC.smoke(RC.get_config(arch)), C.smoke(C.get_config(arch))
    mesh1 = mesh_from_devices(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    params = RM.init(jax.random.PRNGKey(SEED), rcfg)
    prompts = np.random.default_rng(SEED).integers(
        0, rcfg.vocab_size, size=(B, P)).astype(np.int32)
    max_len = P + gen + 1
    tokens = np.asarray(r_serve_batch(rcfg, mesh1, params,
                                      jnp.asarray(prompts), gen_len=gen,
                                      max_len=max_len))
    out = {"prompts": prompts, "tokens": tokens}
    art = r_make_serve_step(rcfg, mesh1, batch=B, max_len=max_len)
    with mesh1:
        state = jax.jit(lambda: RM.init_decode_state(rcfg, B, max_len),
                        out_shardings=art.state_shardings)()
        logits, state = art.prefill_fn(params, state,
                                       {"tokens": jnp.asarray(prompts)})
        kv = state["kv"]
        out.update({"state/k": np.asarray(kv.k), "state/v": np.asarray(kv.v),
                    "state/length": np.asarray(kv.length)})
        for i in range(gen):
            out[f"logits{i}"] = np.asarray(logits, np.float32)
            tok = jnp.argmax(logits[:, :rcfg.vocab_size], -1).astype(
                jnp.int32)
            logits, state = art.decode_fn(params, state, tok[:, None])
    port = interop.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                   "cpu")
    out.update({"params/" + p: t.numpy() for p, t in tree_items(port)})
    np.savez(os.path.join(work, f"serve_{arch}.npz"), **out)
    return {"tokens": tokens}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the steps run here solve their plans into caches of their own, so
    # that no other test sees them in the packages' default contexts
    with r_use_context(plan_cache=RPlanCache()), \
            use_context(plan_cache=PlanCache()):
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dist"))
    rcfg, cfg = RC.smoke(RC.get_config(ARCH)), C.smoke(C.get_config(ARCH))
    tree, ref_loss = _reference(rcfg)
    init = interop.state_from_jax(tree, cfg, "cpu")
    np.savez(os.path.join(work, "init.npz"),
             **{p: t.numpy() for p, t in tree_items(init)})
    prog = os.path.join(work, "rank.py")
    with open(prog, "w") as f:
        f.write(PROG.format(consts=(ARCH, SEQ, BATCH, STEPS, SEED),
                            adafactor=ADAFACTOR, families=FAMILIES,
                            serve=SERVE))
    serve_ref = {a: _reference_serve(a, work) for a in SERVE[0]}
    _wait(_spawn(prog, "mesh8", 8, work), FIXTURE_TIMEOUT)
    later = _spawn(prog, "restore2", 2, work) + _spawn(prog, "mesh1", 1, work)
    _wait(later, FIXTURE_TIMEOUT)
    load = lambda name: (json.load(open(os.path.join(work, name + ".json"))))
    return {
        "ref_loss": ref_loss, "cfg": cfg,
        "serve_ref": serve_ref,
        "mesh8": [load(f"mesh8_rank{r}") for r in range(8)],
        "restore2": [load(f"restore2_rank{r}") for r in range(2)],
        "mesh1": load("mesh1_rank0"),
        "arrays": {m: dict(np.load(os.path.join(work, f"{m}_rank0.npz")))
                   for m in ("mesh8", "restore2", "mesh1")},
        "port": _port_one_device(cfg, init),
        "port_adafactor": _port_one_device(
            cfg, init, opt_lib.OptConfig(**ADAFACTOR)),
    }


def test_ranks_import_no_jax(runs):
    jobs = runs["mesh8"] + runs["restore2"] + [runs["mesh1"]]
    assert not any(r["jax_imported"] for r in jobs)


def test_output_stationary_gemm_correct_with_zero_collectives(runs):
    for r in runs["mesh8"]:
        assert r["os_err"] < 1e-4 and r["os_whole_err"] < 1e-4
        assert r["os_bytes"] == 0


def test_k_sharded_foil_correct_but_communicates(runs):
    for r in runs["mesh8"]:
        assert r["k_err"] < 1e-4
        assert r["k_bytes"] > 0


def test_pipeline_four_stages_over_data(runs):
    for r in runs["mesh8"]:
        assert r["pp_err"] < 1e-5


def test_sharded_loss_matches_reference_and_one_device(runs):
    got = runs["mesh8"][0]["adamw"]["losses"]
    assert abs(got[0] - runs["ref_loss"]) < 5e-3
    for a, b in zip(got, runs["port"]["losses"]):
        assert abs(a - b) <= 1e-4
    for r in runs["mesh8"]:  # every rank reports the DP-mean loss
        assert r["adamw"]["losses"] == got


def _leafwise(arrays, prefix, want, tol_of):
    seen = 0
    for path, w in want.items():
        got = arrays[prefix + path]
        w = w.numpy()
        assert got.shape == w.shape, path
        np.testing.assert_allclose(got, w, rtol=0, atol=tol_of(w),
                                   err_msg=path)
        seen += 1
    assert seen == len(want)


def test_first_step_gradients_match_one_device(runs):
    _leafwise(runs["arrays"]["mesh8"], "adamw/grad/", runs["port"]["grads"],
              lambda w: 1e-4 * max(np.abs(w).max(), 1e-30))


def _lr_sum() -> float:
    cfg = opt_lib.OptConfig()
    return sum(float(opt_lib.schedule(cfg, torch.tensor(s)))
               for s in range(STEPS))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_params_after_two_steps_match_one_device(runs, opt):
    port = runs["port" if opt == "adamw" else "port_adafactor"]
    want = {p[len("params/"):]: t for p, t in port["state"].items()
            if p.startswith("params/")}
    lrs = _lr_sum()
    _leafwise(runs["arrays"]["mesh8"], f"{opt}/state/params/", want,
              lambda w: 1e-5 * np.abs(w).max() + 1e-2 * lrs)
    if opt == "adafactor":
        got = runs["mesh8"][0]["adafactor"]["losses"]
        for a, b in zip(got, port["losses"]):
            assert abs(a - b) <= 1e-4


@pytest.mark.parametrize("name,arch,over", FAMILIES)
def test_other_families_sharded_step_matches_one_device(runs, name, arch,
                                                        over):
    cfg = dataclasses.replace(C.smoke(C.get_config(arch)), **over)
    art = make_train_step(cfg, global_batch=BATCH, seq_len=SEQ, device="cpu")
    with use_context(plan_cache=PlanCache()):
        state, m = art.step_fn(art.init_fn(0),
                               batch_for(cfg, SEQ, BATCH, 0))
    loss, microbatches = runs["mesh8"][0]["family/" + name]
    assert abs(loss - float(m["loss"])) <= 1e-4
    # the DP-aware rule: 2 microbatches of 1 row a rank at 4 x 2
    assert microbatches == (2 if over.get("microbatches") else 1)
    lr = float(opt_lib.schedule(opt_lib.OptConfig(), torch.tensor(0)))
    _leafwise(runs["arrays"]["mesh8"], f"family/{name}/",
              {p: t.detach() for p, t in tree_items(state["params"])},
              lambda w: 1e-5 * np.abs(w).max() + 1e-2 * lr)


def test_dryrun_collective_bytes_equal_measured(runs):
    with use_context(plan_cache=PlanCache()):
        rec = dryrun.train_cell(runs["cfg"],
                                Mesh(("data", "model"), (4, 2)), BATCH, SEQ)
    for r in runs["mesh8"]:
        for measured in r["adamw"]["bytes"]:
            assert measured == rec["cost"]["by_collective"]
    assert rec["cost"]["collective_bytes_per_device"] == sum(
        runs["mesh8"][0]["adamw"]["bytes"][0].values()) > 0


@pytest.mark.parametrize("job", ["restore2", "mesh1"])
def test_checkpoint_saved_at_4x2_restores_equal(runs, job):
    saved = {k[len("adamw/state/"):]: v
             for k, v in runs["arrays"]["mesh8"].items()
             if k.startswith("adamw/state/")}
    got = {k[len("restored/"):]: v for k, v in runs["arrays"][job].items()
           if k.startswith("restored/")}
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    first = runs[job][0] if job == "restore2" else runs[job]
    assert first["restored_step"] == STEPS


def test_one_by_one_mesh_step_is_the_one_device_step(runs):
    arrays = runs["arrays"]["mesh1"]
    plain = {k[len("plain/state/"):]: v for k, v in arrays.items()
             if k.startswith("plain/state/")}
    assert plain
    for k, v in plain.items():
        np.testing.assert_array_equal(arrays["adamw/state/" + k], v,
                                      err_msg=k)
    assert runs["mesh1"]["adamw"]["losses"] == runs["port"]["losses"]
    assert runs["mesh1"]["adamw"]["bytes"] == [{}] * STEPS


def _torchrun(n: int, args: list[str], timeout: float = 240):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-addr", "localhost", "--master-port",
         str(free_port()), "-m", "repro_torch.launch.train", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_launcher_trains_on_a_mesh_and_resumes_on_another(tmp_path):
    """torchrun --nproc-per-node 2: 3 steps on a 2 x 1 mesh with a
    checkpoint every step, then on a 1 x 2 mesh to step 5: it resumes at
    step 3 (the re-mesh) and counts its collectives."""
    common = ["--smoke", "--device", "cpu", "--plan-cache", "", "--batch",
              "4", "--seq", "32", "--ckpt-dir", str(tmp_path),
              "--log-every", "1"]
    a = _torchrun(2, common + ["--mesh", "2x1", "--steps", "3",
                               "--ckpt-every", "1"])
    assert a.returncode == 0, a.stderr[-3000:]
    assert "mesh=2x1" in a.stdout and "start_step=0" in a.stdout
    b = _torchrun(2, common + ["--mesh", "1x2", "--steps", "5",
                               "--ckpt-every", "10"])
    assert b.returncode == 0, b.stderr[-3000:]
    assert "mesh=1x2" in b.stdout and "start_step=3" in b.stdout
    steps = [l for l in b.stdout.splitlines() if l.lstrip().startswith("step")]
    assert len(steps) == 2  # rank 0 prints, steps 3 and 4
    assert all("collective bytes" in l and not l.endswith(" 0")
               for l in steps)


def test_production_mesh_needs_256_ranks():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--plan-cache", "", "--production-mesh"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "needs 256 ranks" in res.stderr


# ------------------------------------------------- tensor parallelism
TP_MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}


def _tp_tag(mesh: str) -> str:
    return "adamw" if mesh == "4x2" else "tp" + mesh


@pytest.mark.parametrize("mesh", ["2x4", "1x8"])
def test_tp_sharded_step_matches_reference_and_one_device(runs, mesh):
    """2 x 4: internlm2-smoke's 2 kv heads on 4 ranks (GQA); 1 x 8: its 4
    heads do not divide 8, the sequence does ('seq')."""
    tag = _tp_tag(mesh)
    got = runs["mesh8"][0][tag]["losses"]
    assert abs(got[0] - runs["ref_loss"]) < 5e-3
    for a, b in zip(got, runs["port"]["losses"]):
        assert abs(a - b) <= 1e-4
    for r in runs["mesh8"]:  # the same loss on every rank of 'model'
        assert r[tag]["losses"] == got
    _leafwise(runs["arrays"]["mesh8"], tag + "/grad/", runs["port"]["grads"],
              lambda w: 1e-4 * max(np.abs(w).max(), 1e-30))
    want = {p[len("params/"):]: t for p, t in runs["port"]["state"].items()
            if p.startswith("params/")}
    lrs = _lr_sum()
    _leafwise(runs["arrays"]["mesh8"], tag + "/state/params/", want,
              lambda w: 1e-5 * np.abs(w).max() + 1e-2 * lrs)


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tp_ranks_do_not_repeat_products(runs, mesh):
    """Each rank's GEMMs of a step (forward and backward, through the
    dispatch listeners) are 1 / (dp x tp) of the one-device step's: the
    ranks along 'model' split the products instead of repeating them."""
    data, model = TP_MESHES[mesh]
    whole = runs["port"]["gemm_flops"]
    for r in runs["mesh8"]:
        assert r[_tp_tag(mesh)]["gemm_flops"] * data * model == whole


@pytest.mark.parametrize("mesh", ["2x4", "1x8"])
def test_tp_dryrun_collective_bytes_equal_measured(runs, mesh):
    with use_context(plan_cache=PlanCache()):
        rec = dryrun.train_cell(runs["cfg"],
                                Mesh(("data", "model"), TP_MESHES[mesh]),
                                BATCH, SEQ)
    for r in runs["mesh8"]:
        for measured in r[_tp_tag(mesh)]["bytes"]:
            assert measured == rec["cost"]["by_collective"]
    assert rec["cost"]["by_collective"]["all_reduce"] > 0


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_vocab_parallel_embed_equals_whole_lookup(runs, mesh):
    model = TP_MESHES[mesh][1]
    for r in runs["mesh8"]:
        got = r["embed" + mesh]
        assert got["block_rows"] == 512 // model
        assert got["err"] == 0.0
        assert got["bytes"] == {"all_reduce": 2 * 7 * 16 * 4}


@pytest.mark.parametrize("arch", SERVE[0])
@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_tp_static_server_matches_reference(runs, mesh, arch):
    """Tokens equal to the reference's serve_batch at 1 x 1 on every rank;
    the prefill's and each step's logits, and a decode step from the
    reference's own prefilled state (interop.shard_state), within 1e-4 of
    1 + |logit|."""
    want = runs["serve_ref"][arch]["tokens"]
    for r in runs["mesh8"]:
        got = r[f"serve{mesh}/{arch}"]
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want)
        assert got["logit_err"] <= 1e-4 and got["handed_err"] <= 1e-4


# each rank's decode-state leaves (L, B / dp, max_len, kv heads, head_dim):
# kv heads over 'model' where they divide it, else head_dim
STATE_SHAPES = {
    ("4x2", "qwen1.5-4b"): [2, 1, 13, 2, 16],
    ("2x4", "qwen1.5-4b"): [2, 2, 13, 1, 16],
    ("4x2", "internlm2-20b"): [2, 1, 13, 1, 16],
    ("2x4", "internlm2-20b"): [2, 2, 13, 2, 4],
}


@pytest.mark.parametrize("mesh,arch", list(STATE_SHAPES))
def test_tp_decode_state_is_its_specs_blocks(runs, mesh, arch):
    for r in runs["mesh8"]:
        shapes = r[f"serve{mesh}/{arch}"]["state_shapes"]
        assert shapes == {"kv/k": STATE_SHAPES[mesh, arch],
                          "kv/v": STATE_SHAPES[mesh, arch], "kv/length": []}


@pytest.mark.parametrize("arch", SERVE[0])
@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_tp_serve_collective_bytes_equal_dryrun(runs, mesh, arch):
    _, B, P, gen = SERVE
    cfg = C.smoke(C.get_config(arch))
    abstract = Mesh(("data", "model"), TP_MESHES[mesh])
    with use_context(plan_cache=PlanCache()):
        pre = dryrun.serve_cell(cfg, abstract, "prefill", B, P)
        dec = dryrun.serve_cell(cfg, abstract, "decode", B, P + gen + 1)
    for r in runs["mesh8"]:
        got = r[f"serve{mesh}/{arch}"]
        assert got["prefill_bytes"] == pre["cost"][
            "collective_bytes_per_device"] > 0
        assert got["decode_bytes"] == [dec["cost"][
            "collective_bytes_per_device"]] * gen


@pytest.mark.parametrize("arch", SERVE[0])
def test_one_by_one_mesh_serve_is_the_one_device_server(runs, arch):
    got = runs["mesh1"][f"serve1x1/{arch}"]
    np.testing.assert_array_equal(np.asarray(got["tokens"]),
                                  runs["serve_ref"][arch]["tokens"])
    assert got["plain_diff"] == 0.0
    assert got["prefill_bytes"] == 0 and not any(got["decode_bytes"])
