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
* int8 (W8A8 under ``quant_mode="int8"``), each family pre-quantized
  (``quantize_params``' tree, as the launchers quantize: the whole weight,
  then a rank's blocks, so a row-parallel block keeps its whole
  ``w_scale``) over 4 x 2 and 2 x 4 and dynamic over 4 x 2, and rwkv
  pre-quantized at a 64-token prompt over 2 x 4 (the chunked WKV on a
  rank's heads); the reference quantizes with its ``prequant``;
* the 1-rank job: each family over a 1 x 1 mesh and on one device, and
  each int8 case on one device.

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
bit. int8: the same, the bytes a dynamic step's the float cell's plus
its W8A8 scales' MAX reductions (``scale_max``), a pre-quantized step's
the abstract mesh's (``tests/test_torch_int8_mesh.py``'s reckoning). In
one process, on an abstract (1, 2) mesh: the tensor-parallel products run
at the local N or K, the WKV recurrence and the SSM scan on a rank's
heads.

Found, and how int8 is held where the packages round apart: at this seed
the port's one-device int8 run lies beyond TOL of the reference's in
three arrays, named in ``TIES``: whisper's last logits (step 4, 0.00287,
pre-quantized and dynamic alike) and rwkv's final WKV state at the
64-token prompt (0.0167 of values up to ~7). Each starts at a tie of the
W8A8 activation quantizer, which
:func:`test_int8_gaps_start_at_a_quantizer_tie` shows from both packages'
quantizer inputs: every activation quantization alike up to one call,
and there one element one int8 step apart, its f64 quotients x / s on
either side of the same k + 1/2 (whisper: step 4's 15th call, row 2,
column 45, x = -1.0035185 in the reference and -1.0035182 in the port,
quotients -50.500011 and -50.499999; rwkv: the prefill's first call, the
absmax 2 f32 ulps apart so the scales 1 ulp apart, element (3, 29, 1),
x = 0.5790153 in both, quotients 27.5 exactly, which rounds half to even
to 28, and 27.499995). The mesh is held to the port's one-device run in
those three arrays alone, every other int8 array to the reference (the
reference's own meshes agree with its one device within 1.9e-5 there).
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
from repro_torch.core import gemm
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.core.plancache import PlanCache
from repro_torch.interop import tree_items, tree_map_with_path
from repro_torch.kernels import wkv as wkv_kernel
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, free_port
from repro_torch.layers import mamba as mb
from repro_torch.quant.prequant import quantize_params
from repro_torch.train.servestep import make_serve_step, prefill_input_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
TOL = 1e-4
SERVE = (4, 4)  # rows, generated tokens
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}
# (arch, mesh, prompt tokens, weights): "float", or int8 (W8A8 under
# quant_mode="int8") pre-quantized ("pre": quantize_params' tree) or
# dynamic ("dyn": the float tree, quantized at every call)
CASES = ([("rwkv6-3b", m, 8, "float") for m in MESHES]
         + [("rwkv6-3b", "2x4", 64, "float")]
         + [("zamba2-1.2b", m, 8, "float") for m in MESHES]
         + [(a, m, 8, "float") for a in ("whisper-base",
                                         "llama-3.2-vision-11b")
            for m in ("4x2", "2x4")]
         + [(a, m, 8, q) for a in ("rwkv6-3b", "zamba2-1.2b", "whisper-base",
                                   "llama-3.2-vision-11b")
            for m, q in (("4x2", "pre"), ("2x4", "pre"), ("4x2", "dyn"))]
         + [("rwkv6-3b", "2x4", 64, "pre")])
ARCHS = sorted({a for a, _, _, _ in CASES})
PROMPTS = sorted({p for _, _, p, _ in CASES})
IDS = [f"{a}-{m}-{p}" + ("" if q == "float" else f"-{q}")
       for a, m, p, q in CASES]
# the reference's runs in two processes side by side (each compiles its
# steps, ~8 s a case)
REF_PARTS = ([c for c in CASES if c[0] in ("rwkv6-3b", "whisper-base")],
             [c for c in CASES if c[0] not in ("rwkv6-3b", "whisper-base")])
TIMEOUT = 600  # seconds, each job
# (arch, prompt, weights): the arrays where the port's one-device int8 run
# and the reference's part at a quantizer tie (module docstring)
TIES = {("rwkv6-3b", 64, "pre"): ("state/wkv",),
        ("whisper-base", 8, "dyn"): ("logits4",),
        ("whisper-base", 8, "pre"): ("logits4",)}
TIE_ULPS = 4  # f32 ulps of the boundary k + 1/2: the farther quotient's

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
import contextlib, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as RC, models as RM
from repro.compat import mesh_from_devices
from repro.core.context import use_context
from repro.parallel import sharding as rshd
from repro.quant import int8 as qz, prequant
from repro.train.servestep import make_serve_step

work, part = sys.argv[1], int(sys.argv[2])
SEED, SERVE, MESHES, CASES, TIES = {consts}
{gates}
z = np.load(os.path.join(work, "inputs.npz"))
out, trees = {{}}, {{}}
calls, _quantize = [], qz.quantize


def recorded(x, scale, axis=None):
    """qz.quantize, recording every per-tensor (activation) call's input
    and scale, in order."""
    if axis is None and jnp.ndim(scale) == 0:
        jax.debug.callback(lambda a, s: calls.append(
            (np.asarray(a, np.float32), np.asarray(s))), x, scale,
            ordered=True)
    return _quantize(x, scale, axis)


def run(key, arch, devices, P, quant):
    rcfg = RC.smoke(RC.get_config(arch))
    if arch not in trees:
        trees[arch] = gated(jax.jit(lambda: RM.init(
            jax.random.PRNGKey(SEED), rcfg))(), rcfg, SEED)
    rp, axes = trees[arch], None
    if quant == "pre":  # as the reference's launcher quantizes
        rp = prequant.quantize_params(rp)
        axes = prequant.quantize_axes(RM.axes(rcfg))
    mesh = mesh_from_devices(devices, ("data", "model"))
    B, gen = SERVE
    max_len = P + gen + 1
    ctx = lambda: (contextlib.nullcontext() if quant == "float"
                   else use_context(quant_mode="int8"))
    with ctx():
        sart = make_serve_step(rcfg, mesh, batch=B, max_len=max_len,
                               param_axes=axes, param_shapes=None
                               if axes is None else jax.eval_shape(
                                   lambda: rp))
    tok_shard = jax.sharding.NamedSharding(mesh, rshd.batch_specs(
        {{"t": jax.ShapeDtypeStruct((B, 1), jnp.int32)}}, mesh)["t"])
    batch = {{"tokens": jnp.asarray(z[f"prompts{{P}}"])}}
    for k in ("frames", "image_embeds"):
        if f"{{arch}}/{{k}}" in z:
            batch[k] = jnp.asarray(z[f"{{arch}}/{{k}}"])
    with mesh, ctx():
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


for arch, mname, P, quant in CASES:
    run(f"{{arch}}/{{mname}}/{{P}}/{{quant}}", arch, np.array(
        jax.devices()).reshape(*MESHES[mname]), P, quant)
# one device, every activation quantization's input and scale recorded
for arch, P, quant in sorted(t for t in TIES if t[0] in
                             {{c[0] for c in CASES}}):
    key = f"{{arch}}/one-{{quant}}/{{P}}"
    calls.clear()
    qz.quantize = recorded
    try:
        run(key, arch, np.array(jax.devices()[:1]).reshape(1, 1), P, quant)
        jax.effects_barrier()
    finally:
        qz.quantize = _quantize
    for i, (x, s) in enumerate(calls):
        out[f"{{key}}/q{{i}}/x"], out[f"{{key}}/q{{i}}/s"] = x, s
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
from repro_torch.quant import int8 as qz
from repro_torch.quant.prequant import quantize_params
from repro_torch.train.servestep import param_blocks

mode, work = sys.argv[1], sys.argv[2]
SEED, SERVE, MESHES, CASES, ARCHS, TIES = {consts}
z = np.load(os.path.join(work, "inputs.npz"))
res, arrays = {{}}, {{}}
calls, _quantize = [], qz.quantize


def recorded(x, scale, axis=None):
    """qz.quantize, recording every per-tensor (activation) call's input
    and scale, in order."""
    if axis is None and scale.dim() == 0:
        calls.append((x.detach().float().numpy().copy(),
                      scale.detach().numpy().copy()))
    return _quantize(x, scale, axis)


def weights(arch):
    cfg = C.smoke(C.get_config(arch))
    w = np.load(os.path.join(work, f"{{arch}}.npz"))
    shapes = models.init(cfg, device="meta")
    it = iter([torch.from_numpy(w[p].copy()) for p, _ in tree_items(shapes)])
    return cfg, tree_map(lambda _: next(it), shapes)


def serve(key, arch, mesh, P, quant="float"):
    """The static server's tokens, every step's logits (whole over DP),
    collective bytes by kind and this rank's final decode state; int8
    (``quant``) under quant_mode="int8", pre-quantized as the launcher
    quantizes (the whole tree, then this rank's blocks) or dynamic."""
    cfg, whole = weights(arch)
    B, gen = SERVE
    extras = {{k: torch.from_numpy(z[f"{{arch}}/{{k}}"].copy())
              for k in ("frames", "image_embeds") if f"{{arch}}/{{k}}" in z}}
    if quant == "pre":
        whole = quantize_params(whole)
    blocks = whole if mesh is None else param_blocks(
        cfg, whole, mesh, quantized=quant == "pre")
    rec = {{}}
    with use_context(quant_mode="int8" if quant != "float" else None):
        toks = serve_batch(cfg, blocks, torch.from_numpy(
            z[f"prompts{{P}}"].copy()).long(), gen_len=gen,
            max_len=P + gen + 1, extras=extras, mesh=mesh, record=rec)
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
        for arch, mname, P, quant in CASES:
            serve(f"{{arch}}/{{mname}}/{{P}}/{{quant}}", arch, meshes[mname],
                  P, quant)
    else:  # 1 x 1 and the one device, and each int8 case on one device
        for arch in ARCHS:
            serve(f"{{arch}}/1x1", arch, make_local_mesh(1, 1, device="cpu"),
                  8)
            serve(f"{{arch}}/one", arch, None, 8)
        for arch, P, quant in sorted({{(a, p, q) for a, _, p, q in CASES
                                      if q != "float"}}):
            key = f"{{arch}}/one-{{quant}}/{{P}}"
            calls.clear()
            if (arch, P, quant) in TIES:
                qz.quantize = recorded
            try:
                serve(key, arch, None, P, quant)
            finally:
                qz.quantize = _quantize
            for i, (x, s) in enumerate(calls):
                arrays[f"{{key}}/q{{i}}/x"], arrays[f"{{key}}/q{{i}}/s"] = x, s
res["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
rank = dist.get_rank()
with open(os.path.join(work, f"{{mode}}_rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
np.savez(os.path.join(work, f"{{mode}}_rank{{rank}}.npz"), **arrays)
dist.destroy_process_group()
'''

exec(GATES)



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
        f.write(PROG.format(consts=(SEED, SERVE, MESHES, CASES, ARCHS,
                                    TIES)))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    refs = []
    for part, cases in enumerate(REF_PARTS):
        path = os.path.join(work, f"ref{part}.py")
        with open(path, "w") as f:
            f.write(REF_PROG.format(consts=(SEED, SERVE, MESHES, cases,
                                            TIES),
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


def _yardstick(runs, arch, prompt, quant, name, want):
    """``want``, the reference's array ``name``; for an array of ``TIES``
    the port's one-device int8 run's
    (:func:`test_int8_gaps_start_at_a_quantizer_tie`)."""
    if name not in TIES.get((arch, prompt, quant), ()):
        return want
    return runs["mesh1_arrays"][f"{arch}/one-{quant}/{prompt}/{name}"]


def _activation_calls(arrays, key) -> list:
    n = sum(k.startswith(f"{key}/q") and k.endswith("/x") for k in arrays)
    assert n > 0, key
    return [(arrays[f"{key}/q{i}/x"], arrays[f"{key}/q{i}/s"])
            for i in range(n)]


@pytest.mark.parametrize("arch,prompt,quant", sorted(TIES))
def test_int8_gaps_start_at_a_quantizer_tie(runs, arch, prompt, quant):
    """On one device, the port's int8 run lies beyond TOL of the
    reference's in the arrays ``TIES`` names and within TOL in every other
    (logits at every step and the final state); and both packages quantize
    every activation alike (input and scale as each package computed them,
    rounded here as both round: half to even) up to one call, where one
    element alone lands one int8 step apart, and its f64 quotients x / s
    lie on either side of the same k + 1/2, one within an f32 ulp of it
    and both within ``TIE_ULPS``: inputs a few f32 roundings apart across
    a rounding boundary."""
    key = f"{arch}/one-{quant}/{prompt}"
    mine, ref = runs["mesh1_arrays"], runs["ref"]
    names = [k[len(key) + 1:] for k in ref
             if k.startswith(key + "/") and "/q" not in k[len(key):]]
    assert set(TIES[arch, prompt, quant]) <= set(names)
    for name in names:
        close = np.allclose(mine[f"{key}/{name}"], ref[f"{key}/{name}"],
                            rtol=TOL, atol=TOL)
        assert close == (name not in TIES[arch, prompt, quant]), name
    got, want = _activation_calls(mine, key), _activation_calls(ref, key)
    assert len(got) == len(want)
    q = lambda x, s: np.clip(np.round(x / s), -127, 127)
    for i, ((x, s), (rx, rs)) in enumerate(zip(got, want)):
        assert x.shape == rx.shape, i
        apart = np.argwhere(q(x, s) != q(rx, rs))
        if len(apart):
            break
    else:
        raise AssertionError("no activation quantized apart")
    assert len(apart) == 1, (i, apart[:4])
    at = tuple(apart[0])
    mine_q = np.float64(x[at]) / np.float64(s)
    ref_q = np.float64(rx[at]) / np.float64(rs)
    assert abs(q(x, s)[at] - q(rx, rs)[at]) == 1, i
    k = np.floor(min(mine_q, ref_q)) + 0.5  # the boundary between them
    ulps = [abs(v - k) / np.spacing(np.float32(k)) for v in (mine_q, ref_q)]
    assert min(mine_q, ref_q) <= k <= max(mine_q, ref_q), (mine_q, ref_q)
    assert min(ulps) <= 1 and max(ulps) <= TIE_ULPS, (i, at, mine_q, ref_q)


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for r in runs["mesh8"] + [runs["mesh1"]])


@pytest.mark.parametrize("arch,mesh,prompt,quant", CASES, ids=IDS)
def test_static_server_matches_reference_over_mesh(runs, arch, mesh,
                                                   prompt, quant):
    key = f"{arch}/{mesh}/{prompt}/{quant}"
    got = runs["mesh8"][0][key]
    B, gen = SERVE
    live = [True] * B  # rows before their first near-tie
    for i in range(gen + 1):
        want = runs["ref"][f"{key}/logits{i}"]
        _close(runs["mesh8_arrays"][0][f"{key}/logits{i}"],
               _yardstick(runs, arch, prompt, quant, f"logits{i}", want),
               f"step {i}")
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


def _ref_state(runs, arch, key, prompt, quant):
    """The reference's final decode state as the port's whole tree, each
    leaf its :func:`_yardstick`."""
    cfg = C.smoke(C.get_config(arch))
    B, gen = SERVE
    shapes = models.init_decode_state(cfg, B, prompt + gen + 1,
                                      device="meta")
    return cfg, tree_map_with_path(
        lambda p, t: torch.from_numpy(_yardstick(
            runs, arch, prompt, quant, f"state/{p}",
            runs["ref"][f"{key}/state/{p}"])), shapes)


@pytest.mark.parametrize("arch,mesh,prompt,quant", CASES, ids=IDS)
def test_final_state_is_shard_state_of_the_reference(runs, arch, mesh,
                                                     prompt, quant):
    """Each rank's final decode state is its block of the reference's
    (``interop.shard_state``); the served tokens are the reference's, so
    the two states saw the same inputs."""
    key = f"{arch}/{mesh}/{prompt}/{quant}"
    cfg, whole = _ref_state(runs, arch, key, prompt, quant)
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


def _quantized_steps(arch, mesh, prompt):
    """The pre-quantized static steps' collective bytes by kind on an
    abstract mesh (meta tensors): (prefill, a decode step)."""
    cfg = C.smoke(C.get_config(arch))
    B, gen = SERVE
    art = make_serve_step(cfg, device="meta", mesh=Mesh(
        ("data", "model"), MESHES[mesh]), quantized=True, batch=B,
        max_len=prompt + gen + 1)
    params = art.shard_params(quantize_params(models.init(cfg,
                                                          device="meta")))
    state = art.init_state(B, prompt + gen + 1)
    meta = lambda shape, dt=torch.int64: torch.zeros(shape, dtype=dt,
                                                     device="meta")
    batch = {k: meta(s, dt) for k, (s, dt) in prefill_input_shapes(
        cfg, B, prompt).items()}
    out = []
    with use_context(quant_mode="int8", plan_cache=PlanCache()):
        with CollectiveCounter() as c:
            art.prefill_fn(params, state, art.rows(batch))
        out.append(c.by_kind())
        with CollectiveCounter() as c:
            art.decode_raw(params, state, art.rows({"t": meta((B, 1))})["t"])
        out.append(c.by_kind())
    return out


def _less(kinds: dict, *drop) -> dict:
    return {k: v for k, v in kinds.items() if k not in drop}


@pytest.mark.parametrize("arch,mesh,prompt,quant", CASES, ids=IDS)
def test_step_bytes_are_the_dry_runs(runs, arch, mesh, prompt, quant):
    """Each step's bytes by kind: the float step's are its dry-run cell's;
    a dynamic int8 step's the float cell's plus its W8A8 scales' MAX
    reductions (``scale_max``); a pre-quantized step's those of the same
    step on an abstract mesh, and but for the parameter gathers (int8
    leaves) the float cell's (``tests/test_torch_int8_mesh.py``'s
    reckoning)."""
    pre, dec = _abstract_steps(arch, mesh, prompt)
    steps = [[rec[f"{arch}/{mesh}/{prompt}/{quant}"][k]
              for k in ("prefill", "decode")] for rec in runs["mesh8"]]
    if quant == "pre":
        qpre, qdec = _quantized_steps(arch, mesh, prompt)
        assert _less(qpre, "scale_max", "all_gather") == _less(
            pre, "all_gather")
        assert _less(qdec, "scale_max", "all_gather") == _less(
            dec, "all_gather")
        pre, dec = qpre, qdec
    for got_pre, got_dec in steps:
        if quant == "dyn":
            assert got_pre["scale_max"] > 0
            assert all(s["scale_max"] > 0 for s in got_dec)
            got_pre = _less(got_pre, "scale_max")
            got_dec = [_less(s, "scale_max") for s in got_dec]
        assert got_pre == pre
        assert all(s == dec for s in got_dec)
    if quant == "pre":
        assert pre["scale_max"] > 0 and dec["scale_max"] > 0
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
                          mesh=Mesh(("data", "model"), (1, 2)), batch=B,
                          max_len=prompt + gen + 1)
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
