"""The static server over a mesh for the rwkv, hybrid, encoder-decoder and
vision families on the CPU, against the reference over the same mesh.

The reference serves every family over any mesh: ``make_serve_step`` is
``jit`` with ``NamedSharding``s (the params by ``param_specs``, the decode
state by ``decode_state_specs``) and GSPMD inserts the collectives. Its own
``serve_batch`` cannot run once 'data' is above 1 (its argmax tokens are
not placed by ``batch_specs``), so the reference's side here drives its
``make_serve_step`` itself with ``device_put`` tokens. The port is
tensor-parallel inside RWKV-6's time-mix (this rank's heads, the WKV
recurrence on them) and channel-mix, and inside Mamba-2 (its SSM heads),
and reads and writes the decode state's blocks in the reference's layout.

This process draws the prompts and the family's extra inputs (numpy, seed
``SEED``) and the reference's init of each smoke model (``PRNGKey(SEED)``;
the vision model's cross-layer gates set nonzero, as
``tests/test_torch_vision.py`` does: at the reference's zero gates a cross
layer adds nothing), writes the port's trees to an .npz, then runs at
once: the reference in two subprocesses with 8 host devices each, 8 gloo
ranks and a 1-rank job, whose ranks import no JAX. Each run is the static server, 4
rows, 8 prompt tokens (rwkv also 64: the chunk-parallel WKV branch on a
rank's heads), 4 generated:

* rwkv-smoke (4 heads of 16) over 4 x 2 (2 heads a rank), 2 x 4 (1 head)
  and 1 x 8 (the heads do not divide 'model': the leaves whole on every
  rank);
* zamba2-smoke (8 SSM heads) over 4 x 2 (``w_in`` stored split), 2 x 4
  and 1 x 8;
* whisper-smoke and vision-smoke over 4 x 2 and 2 x 4;
* the 1-rank job: each family over a 1 x 1 mesh and on one device.

Stated beforehand: every step's logits within rtol = atol = 1e-4 (TOL) of
the reference's over the same mesh (the reference's own spread between
these meshes and 1 x 1 is at most 4.2e-6); the tokens equal up to each
row's first near-tie (the reference's top-2 margin within TOL of 1 +
|top|); every rank alike; each rank's final decode state, within TOL,
``interop.shard_state`` of the reference's final state (the token shifts'
blocks, the WKV state's key-dim block, the conv state whole on every rank
of 'model'); each step's collective bytes by kind those of the same step
on an abstract mesh (``launch.dryrun.serve_cell``), with a nonzero
all-reduce for rwkv and hybrid; a 1 x 1 mesh the one-device path bit for
bit. In one process, on an abstract (1, 2) mesh: the tensor-parallel
products run at the local N or K, the WKV recurrence and the SSM scan on
a rank's heads.
"""
import json
import os
import socket
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
from repro_torch.core import gemm
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items, tree_map_with_path
from repro_torch.kernels import wkv as wkv_kernel
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.layers import mamba as mb
from repro_torch.train.servestep import make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
TOL = 1e-4
SERVE = (4, 4)  # rows, generated tokens
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}
# (arch, mesh, prompt tokens)
CASES = ([("rwkv6-3b", m, 8) for m in MESHES] + [("rwkv6-3b", "2x4", 64)]
         + [("zamba2-1.2b", m, 8) for m in MESHES]
         + [(a, m, 8) for a in ("whisper-base", "llama-3.2-vision-11b")
            for m in ("4x2", "2x4")])
ARCHS = sorted({a for a, _, _ in CASES})
PROMPTS = sorted({p for _, _, p in CASES})
IDS = [f"{a}-{m}-{p}" for a, m, p in CASES]
# the reference's runs in two processes side by side (each compiles its
# steps, ~8 s a case)
REF_PARTS = ([c for c in CASES if c[0] in ("rwkv6-3b", "whisper-base")],
             [c for c in CASES if c[0] not in ("rwkv6-3b", "whisper-base")])
TIMEOUT = 600  # seconds, each job

GATES = r'''
def gated(tree, cfg, seed):
    """The vision tree with both gates of every cross layer nonzero."""
    if cfg.family != "vlm":
        return tree
    rng = np.random.default_rng(seed)
    G = cfg.n_layers // cfg.cross_attn_every
    gate = lambda: np.asarray(rng.uniform(0.5, 1.5, G)
                              * rng.choice([-1.0, 1.0], G), np.float32)
    cross = {**tree["groups"]["cross"], "gate_attn": gate(),
             "gate_mlp": gate()}
    return {**tree, "groups": {**tree["groups"], "cross": cross}}


def items(tree, prefix=""):
    """(path, leaf) of a tree of dicts and NamedTuples, the port's paths."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, f"{prefix}/{k}" if prefix else k)
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from items(getattr(tree, f),
                             f"{prefix}/{f}" if prefix else f)
    else:
        yield prefix, tree
'''

REF_PROG = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as RC, models as RM
from repro.compat import mesh_from_devices
from repro.parallel import sharding as rshd
from repro.train.servestep import make_serve_step

work, part = sys.argv[1], int(sys.argv[2])
SEED, SERVE, MESHES, CASES = {consts}
{gates}
z = np.load(os.path.join(work, "inputs.npz"))
out, trees = {{}}, {{}}
for arch, mname, P in CASES:
    rcfg = RC.smoke(RC.get_config(arch))
    if arch not in trees:
        trees[arch] = gated(jax.jit(lambda: RM.init(
            jax.random.PRNGKey(SEED), rcfg))(), rcfg, SEED)
    rp = trees[arch]
    mesh = mesh_from_devices(np.array(jax.devices()).reshape(
        *MESHES[mname]), ("data", "model"))
    B, gen = SERVE
    max_len = P + gen + 1
    sart = make_serve_step(rcfg, mesh, batch=B, max_len=max_len)
    tok_shard = jax.sharding.NamedSharding(mesh, rshd.batch_specs(
        {{"t": jax.ShapeDtypeStruct((B, 1), jnp.int32)}}, mesh)["t"])
    batch = {{"tokens": jnp.asarray(z[f"prompts{{P}}"])}}
    for k in ("frames", "image_embeds"):
        if f"{{arch}}/{{k}}" in z:
            batch[k] = jnp.asarray(z[f"{{arch}}/{{k}}"])
    key = f"{{arch}}/{{mname}}/{{P}}"
    with mesh:
        st = jax.jit(lambda: RM.init_decode_state(rcfg, B, max_len),
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
    for path, leaf in items(st):
        out[f"{{key}}/state/{{path}}"] = np.asarray(leaf)
np.savez(os.path.join(work, f"ref{{part}}.npz"), **out)
'''

PROG = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs as C
from repro_torch import models
from repro_torch.core.context import use_context
from repro_torch.core.distributed import data_parallel
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items, tree_map
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import serve_batch
from repro_torch.parallel import sharding as shd
from repro_torch.train.servestep import param_blocks

mode, work = sys.argv[1], sys.argv[2]
SEED, SERVE, MESHES, CASES, ARCHS = {consts}
z = np.load(os.path.join(work, "inputs.npz"))
res, arrays = {{}}, {{}}


def weights(arch):
    cfg = C.smoke(C.get_config(arch))
    w = np.load(os.path.join(work, f"{{arch}}.npz"))
    shapes = models.init(cfg, device="meta")
    it = iter([torch.from_numpy(w[p].copy()) for p, _ in tree_items(shapes)])
    return cfg, tree_map(lambda _: next(it), shapes)


def serve(key, arch, mesh, P):
    """The static server's tokens, every step's logits (whole over DP),
    collective bytes by kind and this rank's final decode state."""
    cfg, whole = weights(arch)
    B, gen = SERVE
    extras = {{k: torch.from_numpy(z[f"{{arch}}/{{k}}"].copy())
              for k in ("frames", "image_embeds") if f"{{arch}}/{{k}}" in z}}
    blocks = whole if mesh is None else param_blocks(cfg, whole, mesh)
    rec = {{}}
    toks = serve_batch(cfg, blocks, torch.from_numpy(
        z[f"prompts{{P}}"].copy()).long(), gen_len=gen, max_len=P + gen + 1,
        extras=extras, mesh=mesh, record=rec)
    logits = rec["logits"]
    if mesh is not None and logits[0].shape[0] != B:
        entry = data_parallel(mesh)[0]
        logits = [shd.gather_leaf(t, shd.P(entry), mesh) for t in logits]
    res[key] = {{"tokens": toks.tolist(), "prefill": rec["prefill_by_kind"],
                "decode": rec["decode_by_kind"]}}
    for i, t in enumerate(logits):
        arrays[f"{{key}}/logits{{i}}"] = t[:, :cfg.vocab_size].numpy()
    for path, t in tree_items(rec["state"]):
        arrays[f"{{key}}/state/{{path}}"] = t.numpy()


with use_context(plan_cache=PlanCache()):
    if mode == "mesh8":
        meshes = {{n: make_local_mesh(*s, device="cpu")
                  for n, s in MESHES.items()}}
        for arch, mname, P in CASES:
            serve(f"{{arch}}/{{mname}}/{{P}}", arch, meshes[mname], P)
    else:  # 1 x 1 and the one device
        for arch in ARCHS:
            serve(f"{{arch}}/1x1", arch, make_local_mesh(1, 1, device="cpu"),
                  8)
            serve(f"{{arch}}/one", arch, None, 8)
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
rank = dist.get_rank()
with open(os.path.join(work, f"{{mode}}_rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
np.savez(os.path.join(work, f"{{mode}}_rank{{rank}}.npz"), **arrays)
dist.destroy_process_group()
'''

exec(GATES)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(prog_path: str, mode: str, n: int, work: str) -> list:
    port, procs = _free_port(), []
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
    """The prompts, the encoder frames and image embeddings, and each smoke
    model's reference init as the port's tree."""
    rng = np.random.default_rng(SEED)
    B = SERVE[0]
    vocab = min(RC.smoke(RC.get_config(a)).vocab_size for a in ARCHS)
    arrays = {f"prompts{p}": rng.integers(0, vocab, size=(B, p)).astype(
        np.int32) for p in PROMPTS}
    for arch in ARCHS:
        rcfg, cfg = RC.smoke(RC.get_config(arch)), C.smoke(C.get_config(arch))
        if cfg.family == "encdec":
            arrays[f"{arch}/frames"] = rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            arrays[f"{arch}/image_embeds"] = rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        tree = gated(jax.tree.map(np.asarray, jax.jit(lambda: RM.init(
            jax.random.PRNGKey(SEED), rcfg))()), rcfg, SEED)
        port = interop.params_from_jax(tree, cfg, "cpu")
        np.savez(os.path.join(work, f"{arch}.npz"),
                 **{p: t.numpy() for p, t in tree_items(port)})
    np.savez(os.path.join(work, "inputs.npz"), **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("family_mesh"))
    _inputs(work)
    prog = os.path.join(work, "rank.py")
    with open(prog, "w") as f:
        f.write(PROG.format(consts=(SEED, SERVE, MESHES, CASES, ARCHS)))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    refs = []
    for part, cases in enumerate(REF_PARTS):
        path = os.path.join(work, f"ref{part}.py")
        with open(path, "w") as f:
            f.write(REF_PROG.format(consts=(SEED, SERVE, MESHES, cases),
                                    gates=GATES))
        refs.append(subprocess.Popen(
            [sys.executable, path, work, str(part)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    jobs = _spawn(prog, "mesh8", 8, work) + _spawn(prog, "mesh1", 1, work)
    _wait(jobs + refs, TIMEOUT)
    load = lambda name: json.load(open(os.path.join(work, name + ".json")))
    npz = lambda name: dict(np.load(os.path.join(work, name + ".npz")))
    ref = {}
    for part in range(len(REF_PARTS)):
        ref.update(npz(f"ref{part}"))
    return {"ref": ref,
            "mesh8": [load(f"mesh8_rank{r}") for r in range(8)],
            "mesh8_arrays": [npz(f"mesh8_rank{r}") for r in range(8)],
            "mesh1": load("mesh1_rank0"), "mesh1_arrays": npz("mesh1_rank0")}


def _close(got, want, msg="") -> None:
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=msg)


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for r in runs["mesh8"] + [runs["mesh1"]])


@pytest.mark.parametrize("arch,mesh,prompt", CASES, ids=IDS)
def test_static_server_matches_reference_over_mesh(runs, arch, mesh,
                                                   prompt):
    key = f"{arch}/{mesh}/{prompt}"
    got = runs["mesh8"][0][key]
    B, gen = SERVE
    live = [True] * B  # rows before their first near-tie
    for i in range(gen + 1):
        want = runs["ref"][f"{key}/logits{i}"]
        _close(runs["mesh8_arrays"][0][f"{key}/logits{i}"], want, f"step {i}")
        if i == gen:
            break
        for row in range(B):
            top = np.sort(want[row].astype(np.float64))[-2:]
            live[row] = live[row] and top[1] - top[0] > TOL * (
                1 + abs(top[1]))
            if live[row]:
                assert got["tokens"][row][i] == int(np.argmax(want[row]))
    for rec in runs["mesh8"][1:]:
        assert rec[key]["tokens"] == got["tokens"]


def _ref_state(ref, arch, key, prompt):
    """The reference's final decode state as the port's whole tree."""
    cfg = C.smoke(C.get_config(arch))
    B, gen = SERVE
    shapes = models.init_decode_state(cfg, B, prompt + gen + 1,
                                      device="meta")
    return cfg, tree_map_with_path(
        lambda p, t: torch.from_numpy(ref[f"{key}/state/{p}"]), shapes)


@pytest.mark.parametrize("arch,mesh,prompt", CASES, ids=IDS)
def test_final_state_is_shard_state_of_the_reference(runs, arch, mesh,
                                                     prompt):
    """Each rank's final decode state is its block of the reference's
    (``interop.shard_state``); the served tokens are the reference's, so
    the two states saw the same inputs."""
    key = f"{arch}/{mesh}/{prompt}"
    cfg, whole = _ref_state(runs["ref"], arch, key, prompt)
    shape = MESHES[mesh]
    want_tokens = [[int(np.argmax(runs["ref"][f"{key}/logits{i}"][row]))
                    for i in range(SERVE[1])] for row in range(SERVE[0])]
    assert runs["mesh8"][0][key]["tokens"] == want_tokens
    for rank in range(8):
        coords = (rank // shape[1], rank % shape[1])
        want = interop.shard_state(whole, None, Mesh(("data", "model"),
                                                     shape, coords=coords),
                                   cfg=cfg)
        got = runs["mesh8_arrays"][rank]
        for path, t in tree_items(want):
            g = got[f"{key}/state/{path}"]
            assert g.shape == tuple(t.shape), (rank, path)
            _close(g, t.numpy(), f"rank {rank} {path}")


def _abstract_steps(arch, mesh, prompt):
    """The static steps' collective bytes by kind on an abstract mesh (the
    dry run's serve cells): (prefill, a decode step)."""
    cfg = C.smoke(C.get_config(arch))
    B, gen = SERVE
    abstract = Mesh(("data", "model"), MESHES[mesh])
    with use_context(plan_cache=PlanCache()):
        return (dryrun.serve_cell(cfg, abstract, "prefill", B, prompt)[
                    "cost"]["by_collective"],
                dryrun.serve_cell(cfg, abstract, "decode", B,
                                  prompt + gen + 1)["cost"]["by_collective"])


@pytest.mark.parametrize("arch,mesh,prompt", CASES, ids=IDS)
def test_step_bytes_are_the_dry_runs(runs, arch, mesh, prompt):
    pre, dec = _abstract_steps(arch, mesh, prompt)
    for rec in runs["mesh8"]:
        got = rec[f"{arch}/{mesh}/{prompt}"]
        assert got["prefill"] == pre
        assert all(s == dec for s in got["decode"])
    if C.get_config(arch).family in ("rwkv", "hybrid"):
        assert pre["all_reduce"] > 0 and dec["all_reduce"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_the_one_device_path_bit_for_bit(runs, arch):
    one, a = runs["mesh1"], runs["mesh1_arrays"]
    got, want = one[f"{arch}/1x1"], one[f"{arch}/one"]
    assert got["tokens"] == want["tokens"]
    assert got["prefill"] == {} and all(s == {} for s in got["decode"])
    keys = [k[len(f"{arch}/one/"):] for k in a if k.startswith(f"{arch}/one/")]
    assert any(k.startswith("state/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(a[f"{arch}/1x1/{k}"], a[f"{arch}/one/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("arch,prompt", [("rwkv6-3b", 64),
                                         ("zamba2-1.2b", 8)])
def test_tensor_parallel_runs_at_the_local_shapes(arch, prompt,
                                                  monkeypatch):
    """Over 'model' = 2 (abstract, meta tensors): every rwkv time-mix
    projection (r, k, v, g, the decay's up-projection) at d/2 columns and
    ``wo`` at d/2 rows, the channel-mix at d_ff/2; Mamba-2's ``w_in`` at
    the block of columns a rank stores (half its width) and ``w_out`` at
    d_inner/2 rows; the WKV recurrence (the chunk-parallel prefill's
    ``wkv_heads``) and the SSM scan on H/2 heads."""
    cfg = C.smoke(C.get_config(arch))
    d, B, gen = cfg.d_model, *SERVE
    seen, heads = [], []
    listener = lambda key, plan: seen.append(key[1:4])
    real_wkv, real_ssd = wkv_kernel.wkv_heads, mb._ssd_step

    def wkv(r, *a, **k):
        heads.append(r.shape[2])
        return real_wkv(r, *a, **k)

    def ssd(state, xh, *a):
        heads.append(xh.shape[1])
        return real_ssd(state, xh, *a)

    monkeypatch.setattr(wkv_kernel, "wkv_heads", wkv)
    monkeypatch.setattr(mb, "_ssd_step", ssd)
    art = make_serve_step(cfg, device="meta",
                          mesh=Mesh(("data", "model"), (1, 2)))
    params = art.shard_params(models.init(cfg, device="meta"))
    state = art.init_state(B, prompt + gen + 1)
    meta = lambda shape: torch.zeros(shape, dtype=torch.int64, device="meta")
    gemm.add_dispatch_listener(listener)
    try:
        with use_context(plan_cache=PlanCache()), CollectiveCounter() as c:
            art.prefill_fn(params, state, {"tokens": meta((B, prompt))})
            art.decode_raw(params, state, meta((B, 1)))
    finally:
        gemm.remove_dispatch_listener(listener)
    assert c.by_kind()["all_reduce"] > 0
    if arch == "rwkv6-3b":
        local = cfg.n_heads // 2
        L, lora = cfg.n_layers, 32
        for t in (prompt, 1):
            M = B * t
            # r, k, v, g at d/2 columns (and the decay's whole
            # down-projection, d x 32 = d/2 at this width), wo at d/2
            # rows, the decay's up-projection at d/2 columns
            assert seen.count((M, d, d // 2)) == 5 * L
            assert seen.count((M, d // 2, d)) == L
            assert seen.count((M, lora, d // 2)) == L
            assert {(M, d, cfg.d_ff // 2), (M, cfg.d_ff // 2, d)} <= set(
                seen)
    else:
        d_inner, H = mb.dims(d, cfg.ssm_state, expand=cfg.ssm_expand,
                             head_dim=cfg.ssm_head_dim)
        local = H // 2
        cols = (2 * d_inner + 2 * cfg.ssm_state + H) // 2  # w_in's block
        assert {(B * t, d, cols) for t in (prompt, 1)} | {
            (B * t, d_inner // 2, d) for t in (prompt, 1)} <= set(seen)
    assert heads and set(heads) == {local}
