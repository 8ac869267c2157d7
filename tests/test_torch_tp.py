"""Tensor parallelism over 'model', in one process (the multi-rank parity
runs are in tests/test_torch_distributed.py's 8-rank job).

An abstract mesh (``launch.mesh.Mesh`` without process groups) runs the
sharded layers on the meta device: the collective helpers count the bytes
a rank would move and move nothing. That reckons each layer's collectives
exactly: a tensor-parallel MLP call is one all-reduce of its (B, S, d) f32
output, an attention block in 'heads' mode one more, 'seq' mode gathers
k, v and the output rows. Also here: which leaves a plan keeps as 'model'
blocks, the mode rule, the dry run's model-FLOPs ratio on the production
mesh, the other families' decode all-reduces over 'model' in float and
int8, the W8A8 MLP's count over 'model', a cache whose kv heads and
head_dim 'model' divides neither (its sequence over 'model', or whole),
the backends' refusals, and the launcher under torchrun on 8 CPU ranks
against the one-device server.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as C
from repro_torch import models
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.core.plancache import PlanCache
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, free_port, init_mesh,
                                     make_production_mesh)
from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_lib
from repro_torch.models import lm
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import report
from repro_torch.train.servestep import make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16


def _layer0(cfg, mesh):
    """Layer 0's leaves as a sharded plan hands them to the layers (meta),
    and the plan."""
    params = models.init(cfg, device="meta")
    specs = shd.param_specs(models.axes(cfg), params, mesh)
    plan = fsdp.ShardPlan(mesh, specs)
    local = shd.shard_tree(params, specs, mesh)
    return plan.layer(lm._layer(local["layers"], 0), "layers"), plan


def _count(cfg, shape, fn):
    mesh = Mesh(("data", "model"), shape)
    lp, plan = _layer0(cfg, mesh)
    x = torch.empty((B, S, cfg.d_model), dtype=cfg.dtype, device="meta")
    with torch.no_grad(), use_context(mesh=mesh, shard=plan,
                                      plan_cache=PlanCache()), \
            CollectiveCounter() as c:
        y = fn(lp, x)
    assert tuple(y.shape) == (B, S, cfg.d_model)
    return c.by_kind()


def test_mlp_is_one_all_reduce_a_call():
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    got = _count(cfg, (1, 2), lambda lp, x: mlp_lib.mlp(
        lp["mlp"], x, activation=cfg.activation))
    assert got == {"all_reduce": B * S * cfg.d_model * 4}


def test_block_is_two_all_reduces_in_heads_mode():
    """qwen-smoke's 4 heads on 'model' = 2: attention and MLP each end in
    one all-reduce of the (B, S, d) f32 partial sums."""
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    got = _count(cfg, (1, 2), lambda lp, x: lm._block(cfg, lp, x)[0])
    assert got == {"all_reduce": 2 * B * S * cfg.d_model * 4}


def test_gqa_heads_mode_gathers_the_kv_columns():
    """internlm2-smoke's 2 kv heads on 'model' = 4: k and v of every kv
    head, their column blocks' outputs all-gathered; wo row-parallel."""
    cfg = C.smoke(C.get_config("internlm2-20b"))
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    got = _count(cfg, (1, 4), lambda lp, x: attn.self_attention(
        lp["attn"], x, **lm._attn_kw(cfg)))
    assert got == {"all_gather": 2 * B * S * kv_dim // 4 * 4,
                   "all_reduce": B * S * cfg.d_model * 4}


def test_seq_mode_gathers_leaves_kv_and_rows():
    """4 heads on 'model' = 8, S = 16: the q/k/v/o leaves gathered, k and v
    of this rank's 2 rows gathered along S, the output rows gathered."""
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    leaves = (d * q_dim + 2 * d * kv_dim + q_dim * d + q_dim + 2 * kv_dim)
    rows = S // 8
    got = _count(cfg, (1, 8), lambda lp, x: attn.self_attention(
        lp["attn"], x, **lm._attn_kw(cfg)))
    assert got == {"all_gather": 4 * (leaves // 8) + 4 * (
        2 * B * rows * kv_dim + B * rows * d)}


def test_plan_keeps_the_model_blocks_of_tp_leaves():
    cfg = C.get_config("qwen1.5-4b")
    mesh = make_production_mesh()
    params = models.init(cfg, device="meta")
    plan = fsdp.ShardPlan(mesh, shd.param_specs(models.axes(cfg), params,
                                                mesh))
    assert {p for p in plan.blocked if not p.startswith("layers/")} == {
        "embed", "unembed"}
    assert {p.split("/")[1] for p in plan.blocked
            if p.startswith("layers/")} == {"attn", "mlp"}
    # wq (embed, heads): gathered over 'data' only, kept split on dim 1
    assert plan.split("layers/attn/wq", shd.P(None, "data", "model")) == (
        shd.P(None, "data", None), 2)
    assert plan.split("layers/ln1/g", shd.P(None, "data")) == (
        shd.P(None, "data"), None)
    one = fsdp.ShardPlan(Mesh(("data", "model"), (16, 1)), plan.specs)
    assert not one.blocked


def test_tp_mode_needs_a_plan_and_head_blocks():
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    lp, plan = _layer0(cfg, Mesh(("data", "model"), (1, 2)))
    assert attn._tp_mode(lp["attn"], 4, 16) == "none"  # no plan installed
    with use_context(mesh=plan.mesh, shard=plan):
        assert attn._tp_mode(lp["attn"], 4, 16) == "heads"
    lp8, plan8 = _layer0(cfg, Mesh(("data", "model"), (1, 8)))
    with use_context(mesh=plan8.mesh, shard=plan8):
        assert attn._tp_mode(lp8["attn"], 4, 16) == "seq"
        assert attn._tp_mode(lp8["attn"], 4, 12) == "none"


def test_dryrun_train_cell_useful_flops_ratio(tmp_path):
    """qwen1.5-4b x train_4k on 16 x 16: the ranks of 'model' split the
    step's products, so 6ND over the counted FLOPs is about 0.5 (0.03
    while they repeated them)."""
    with use_context(plan_cache=PlanCache()):
        rec = dryrun.run_cell("qwen1.5-4b", "train_4k", False,
                              str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    ratio = report.enrich(rec, hw="h100")["roofline"]["useful_flops_ratio"]
    assert 0.4 <= ratio <= 1.0
    assert rec["cost"]["by_collective"]["all_reduce"] > 0


def _decode_kinds(cfg, shape) -> dict[str, int]:
    """The collective bytes by kind of the static server's decode step of
    B rows on an abstract mesh (the float tree: under quant_mode="int8"
    the dynamic W8A8 path)."""
    art = make_serve_step(cfg, device="meta", mesh=Mesh(("data", "model"),
                                                        shape), batch=B,
                          max_len=8)
    params = art.shard_params(models.init(cfg, device="meta"))
    state = art.init_state(B, 8)
    with use_context(plan_cache=PlanCache()), CollectiveCounter() as c:
        art.decode_raw(params, state, torch.zeros((B, 1), dtype=torch.int64,
                                                  device="meta"))
    return c.by_kind()


def test_static_steps_serve_the_state_they_were_made_for():
    """Over (1, 3), where 3 divides neither qwen-smoke's 4 kv heads nor its
    head_dim 16, the cache's layout follows ``max_len`` (12: the sequence
    over 'model', a rank's 4 positions; 13: whole): the static steps are
    made for one batch and ``max_len`` and refuse a state of another,
    however it was made, rather than write it in another layout; a family
    without a KV cache takes any."""
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    mesh = Mesh(("data", "model"), (1, 3), coords=(0, 2))
    seq = make_serve_step(cfg, device="meta", mesh=mesh, batch=B, max_len=12)
    whole = make_serve_step(cfg, device="meta", mesh=mesh, batch=B,
                            max_len=13)
    params = seq.shard_params(models.init(cfg, device="meta"))
    tok = torch.zeros((B, 1), dtype=torch.int64, device="meta")
    assert seq.init_state(B, 12)["kv"].k.shape[2] == 4
    assert whole.init_state(B, 13)["kv"].k.shape[2] == 13
    with use_context(plan_cache=PlanCache()):
        seq.decode_raw(params, seq.init_state(B, 12), tok)
        for art, other in ((seq, (B, 13)), (whole, (B, 12)),
                           (seq, (B + 1, 12))):
            with pytest.raises(ValueError, match="made for"):
                art.init_state(*other)
        with pytest.raises(ValueError, match="steps read it as"):
            seq.decode_raw(params, whole.init_state(B, 13), tok)
        bare = make_serve_step(cfg, device="meta", mesh=mesh)
        for call in (lambda: bare.init_state(B, 12),
                     lambda: bare.decode_raw(params, seq.init_state(B, 12),
                                             tok)):
            with pytest.raises(ValueError, match="max_len="):
                call()
        rwkv = C.smoke(C.get_config("rwkv6-3b"))
        art = make_serve_step(rwkv, device="meta", mesh=mesh)
        art.decode_raw(art.shard_params(models.init(rwkv, device="meta")),
                       art.init_state(B, 9), tok)


def test_refusals():
    # every family serves over 'model' (no longer refused): the decode
    # step's all-reduces of (B, 1, d) f32 partials over 'model' = 2 (the
    # vocab-parallel lookup's, and a layer's row-parallel products: rwkv's
    # time-mix wo and channel-mix wv, Mamba-2's w_out beside its gated
    # norm's (B, 1, 1) sum of squares and the shared block's attention
    # and MLP at layer 0, whisper's decoder self, cross and MLP); int8
    # over a mesh runs for them too (no longer refused): the int32
    # partials of the row-parallel W8A8 products take the float partials'
    # all-reduce bytes, beside their scales' MAX over 'model'
    row = B * C.smoke(C.get_config("qwen1.5-4b")).d_model * 4
    want = {"rwkv6-3b": (1 + 2 * 2) * row,
            "zamba2-1.2b": (1 + 2 + 2) * row + 2 * B * 4,
            "whisper-base": (1 + 3 * 2) * row}
    for arch, n in want.items():
        cfg = C.smoke(C.get_config(arch))
        assert cfg.d_model * 4 * B == row and cfg.n_layers == 2
        assert _decode_kinds(cfg, (1, 2))["all_reduce"] == n
        with use_context(quant_mode="int8"):
            got = _decode_kinds(cfg, (1, 2))
        assert got.pop("scale_max") > 0 and got["all_reduce"] == n
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    # W8A8 runs over 'model' (no longer refused): the row-parallel w_out's
    # int32 partials take the float partials' all-reduce bytes, and its
    # activation scale and its float weight's per-channel absmax each one
    # MAX over 'model'
    with use_context(quant_mode="int8"):
        got = _count(cfg, (1, 2), lambda lp, x: mlp_lib.mlp(lp["mlp"], x))
    assert got == {"all_reduce": B * S * cfg.d_model * 4,
                   "scale_max": 4 + 4 * cfg.d_model}
    # neither 4 kv heads nor head_dim 16 divide 'model' = 32 (no longer
    # refused): the cache's sequence lies over 'model' where the state's
    # layout puts it there (its last block at rank 31), else it is whole
    lp, plan = _layer0(cfg, Mesh(("data", "model"), (1, 32),
                                 coords=(0, 31)))
    with use_context(mesh=plan.mesh, shard=plan):
        assert attn._cache_layout(4, 16) == "whole"
    kv = shd.P(None, None, "model", None, None)
    with use_context(mesh=plan.mesh, shard=plan.with_kv(kv)):
        dp = attn._over_dp(B, B, -3, 2)
        assert dp.held == (62, 2) and dp.lanes is None
        assert attn._cache_layout(4, 16, dp) == "seq"
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        init_mesh((1, 1), ("data", "model"), device="cpu", backend="nccl")
    assert Mesh(("data", "model"), (1, 2), backend="gloo").describe() == \
        "1x2 {'data': 1, 'model': 2} backend=gloo"



def _serve_cli(args, n: int | None = None):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    head = [sys.executable]
    if n is not None:
        head += ["-m", "torch.distributed.run", "--nproc-per-node", str(n),
                 "--master-addr", "localhost", "--master-port",
                 str(free_port())]
    return subprocess.run(
        head + ["-m", "repro_torch.launch.serve", "--smoke", "--device",
                "cpu", "--plan-cache", "", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)


def test_launcher_serves_on_a_4x2_mesh_like_one_device():
    """torchrun --nproc-per-node 8 ... --mesh 4x2: rank 0 prints once, the
    plans warm at the local shapes (no lazy solve), the tokens are the
    one-device run's, the collective bytes are counted."""
    one = _serve_cli([])
    assert one.returncode == 0, one.stderr[-3000:]
    run = _serve_cli(["--mesh", "4x2"], n=8)
    assert run.returncode == 0, run.stderr[-3000:]
    first = lambda out: re.findall(r"first row: .*", out)
    assert first(run.stdout) == first(one.stdout) and first(one.stdout)
    assert "4x2 {'data': 4, 'model': 2} backend=gloo" in run.stdout
    assert "lazy_solves=0" in run.stdout
    assert re.search(r"collective bytes a rank: prefill [1-9]", run.stdout)
    bad = _serve_cli(["--backend", "gloo"])
    assert bad.returncode != 0 and "--backend goes with --mesh" in bad.stderr


def test_attention_without_head_counts_takes_them_from_the_cache():
    """Off a tensor-parallel plan the head counts are optional (the cache
    shows them): a pre-quantized layer's prefill and decode, as a caller
    outside the models issues them, equal the models' calls."""
    from repro_torch.quant.prequant import quantize_params

    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    lp = lm._layer(quantize_params(models.init(cfg, seed=0, device="cpu"))[
        "layers"], 0)["attn"]
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim)
    out = []
    for heads in ({}, kw):
        cache = attn.init_kv_cache(B, S + 1, cfg.n_kv_heads, cfg.head_dim,
                                   torch.float32, device="cpu")
        with use_context(plan_cache=PlanCache()):
            y, cache = attn.prefill_attention(lp, x, cache, **heads)
            cache = cache._replace(length=torch.tensor(S, dtype=torch.int32))
            z, _ = attn.decode_attention(lp, x[:, :1], cache, **heads)
        out.append((y, z))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
