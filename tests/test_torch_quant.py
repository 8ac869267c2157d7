"""The port's int8 quantization (``repro_torch.quant``,
``layers/quantized.py``, ``dense``'s dispatch, the int8 static server)
against the reference's, on the CPU, from the same numpy inputs.

Tolerances:
* the quantizers (``quant/int8.py``, ``quant/kvcache.py``), the prequantized
  leaves and scales, the quantized activations and an int8-output
  ``qdense`` are held **exactly**: the same f32 division, half-to-even
  rounding and clip on both sides, and an int8 product is exact;
* a float-output ``qdense`` is exact too without an activation or with
  relu (the i32 product is exact; the epilogue is the same f32 multiply
  and add). silu and gelu are each side's own library function, which may
  differ by an f32 ulp: held to rtol 2.4e-7 (two f32 ulps) for an f32
  output and one bf16 ulp (2^-7 relative) for a bf16 output;
* the 2-layer model logits under ``quant_mode="int8"``: with f32
  activations both sides differ only in the summation order of the float
  ops around the GEMMs (norms, rotary, attention): rtol = atol = 1e-4, as
  ``tests/test_torch_lm.py``. With bf16 activations a bf16 rounding flip
  in those ops moves an element across an int8 rounding boundary, or the
  per-tensor absmax itself, and the next GEMM's input changes by whole
  int8 steps: the reference moves by up to 0.116 (|d| / (1 + |logit|)) on
  qwen-smoke at d_model 256 when only its embedding is scaled by
  1 + 2^-20, against 0.030 for its float path; port against reference
  measured 0.08-0.14 (qwen) and 0.13-0.20 (rwkv) over d_model 64-512. The
  bf16 logits are held to |d| <= 0.25 (1 + |logit|).

The reference runs on its plain XLA path (``matmul_backend="xla"``), or in
interpret mode where a test says so.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro import models as RM
from repro import quant as RQ
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.layers import attention as RA
from repro.layers import mlp as RMLP
from repro.layers import quantized as RQL
from repro.quant import prequant as RP
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch import quant as TQ
from repro_torch.core.context import GemmContext
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.kernels import matmul as tmm
from repro_torch.launch import serve as tserve
from repro_torch.layers import attention as TA
from repro_torch.layers import common as tcm
from repro_torch.layers import mlp as TMLP
from repro_torch.layers import quantized as TQL
from repro_torch.quant import prequant as TP

RNG = np.random.default_rng(42)
BF16_TOL = 0.25


@pytest.fixture(autouse=True)
def _seed():
    """Each test draws its inputs from the same seed, whatever ran before."""
    global RNG
    RNG = np.random.default_rng(42)


def _randf(shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _np(x) -> np.ndarray:
    """A JAX or torch array as numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _same(got, want) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- quant/int8.py
INPUTS = {
    "normal": lambda: _randf((64, 48)),
    "wide range": lambda: np.stack([_randf((128,), 1e-3),
                                    _randf((128,), 10.0)], 1),
    "zeros": lambda: np.zeros((4, 8), np.float32),
    "zero rows": lambda: np.stack([np.zeros(16, np.float32),
                                   np.full(16, 2.54, np.float32)]),
    "extremes": lambda: np.array([[-1e9, 1e9, 0.0, -0.3]], np.float32),
    "ties": lambda: (np.arange(-254, 255, dtype=np.float32) / 2
                     ).reshape(1, -1),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_and_scales_match_reference_exactly(name, axis):
    x = INPUTS[name]()
    rs = RQ.absmax_scale(jnp.asarray(x), axis=axis)
    ts = TQ.absmax_scale(torch.from_numpy(x), axis=axis)
    _same(ts, rs)
    rq = RQ.quantize(jnp.asarray(x), rs, axis=axis)
    tq = TQ.quantize(torch.from_numpy(x), ts, axis=axis)
    assert tq.dtype == torch.int8
    _same(tq, rq)
    assert int(tq.min()) >= -TQ.QMAX  # -128 is never emitted
    _same(TQ.dequantize(tq, ts, axis=axis), RQ.dequantize(rq, rs, axis=axis))
    if axis is None:
        # symmetric grid: the round trip is within half a step
        err = (TQ.dequantize(tq, ts) - torch.from_numpy(x)).abs().max()
        assert float(err) <= float(ts) / 2 + 1e-7


@pytest.mark.parametrize("scale", [0.0, -1.0])
def test_non_positive_scale_acts_as_one(scale):
    x = _randf((8, 4))
    s = np.float32(scale)
    tq = TQ.quantize(torch.from_numpy(x), torch.tensor(s))
    _same(tq, RQ.quantize(jnp.asarray(x), jnp.asarray(s)))
    back = TQ.dequantize(tq, torch.tensor(s))
    assert torch.isfinite(back).all()
    np.testing.assert_array_equal(back.numpy(), tq.float().numpy())


@pytest.mark.parametrize("kind", ["per_tensor", "per_channel"])
def test_qtensor_constructors_match_reference(kind):
    w = np.stack([_randf((128,), 0.001), _randf((128,), 1.0)], axis=1)
    if kind == "per_tensor":
        r, t = RQ.quantize_per_tensor(jnp.asarray(w)), \
            TQ.quantize_per_tensor(torch.from_numpy(w))
    else:
        r, t = RQ.quantize_per_channel(jnp.asarray(w), 1), \
            TQ.quantize_per_channel(torch.from_numpy(w), 1)
        assert float(t.scale[1] / t.scale[0]) > 100
    _same(t.q, r.q)
    _same(t.scale, r.scale)


@pytest.mark.parametrize("axis", [None, 1])
def test_calibrator_matches_reference(axis):
    batches = [_randf((4, 6)), _randf((4, 6), 3.0), np.zeros((4, 6),
                                                           np.float32)]
    rc, tc = RQ.Calibrator(axis=axis), TQ.Calibrator(axis=axis)
    for b in batches:
        rc.observe(jnp.asarray(b))
        tc.observe(torch.from_numpy(b))
    _same(tc.scale(), rc.scale())
    with pytest.raises(ValueError):
        TQ.Calibrator().scale()


def test_combine_scales_matches_reference():
    a, b = np.float32(0.013), _randf((7,), 0.01)
    _same(TQ.combine_scales(torch.tensor(a), torch.from_numpy(b)),
          RQ.combine_scales(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("bs", [1, 4, 8, 16])
@pytest.mark.parametrize("zero_head", [False, True])
def test_quantize_block_matches_reference_and_round_trips(bs, zero_head):
    x = _randf((5, bs, 3, 8), 3.0)
    if zero_head:
        x[:, :, 1, :] = 0.0
    rq, rs = RQ.quantize_block(jnp.asarray(x))
    tq, ts = TQ.quantize_block(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.shape == (5, 3)
    _same(tq, rq)
    _same(ts, rs)
    back = TQ.dequantize_block(tq, ts)
    _same(back, RQ.dequantize_block(rq, rs))
    assert ((back - torch.from_numpy(x)).abs()
            <= ts[:, None, :, None] / 2 + 1e-7).all()
    if zero_head:
        assert (ts[:, 1] == 1.0).all() and (back[:, :, 1] == 0).all()
    assert TQ.dequantize_block(tq, ts, torch.bfloat16).dtype == torch.bfloat16


def test_quantize_block_zero_block_is_exact():
    tq, ts = TQ.quantize_block(torch.zeros((2, 4, 3, 8)))
    assert (ts == 1.0).all() and (tq == 0).all()
    assert (TQ.dequantize_block(tq, ts) == 0).all()


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("bias", [False, True])
def test_quantize_linear_matches_reference(lead, bias):
    w = _randf((*lead, 40, 24), 0.2)
    w[..., 5] = 0.0  # an all-zero output channel: scale 1.0
    b = _randf((*lead, 24)) if bias else None
    fn = RQ.quantize_linear
    for _ in lead:
        fn = jax.vmap(fn)
    r = fn(jnp.asarray(w), None if b is None else jnp.asarray(b))
    t = TQ.quantize_linear(torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b))
    assert t.w_q.shape == (*lead, 24, 40) and t.w_q.is_contiguous()
    _same(t.w_q, r.w_q)
    _same(t.w_scale, r.w_scale)
    assert (t.bias is None) == (r.bias is None)
    if bias:
        _same(t.bias, r.bias)


# ---------------------------------------------------- quant/kvcache.py
@pytest.mark.parametrize("name", [None, "none", "bf16", "int8"])
def test_kv_cache_dtype_matches_reference(name):
    r, t = RQ.KVCacheDtype.parse(name), TQ.KVCacheDtype.parse(name)
    assert t.value == r.value and t.quantized == r.quantized
    assert t.itemsize == r.itemsize
    assert t.storage_dtype.itemsize == jnp.dtype(r.storage_dtype).itemsize
    assert t.scale_bytes_per_block(20) == r.scale_bytes_per_block(20)
    assert TQ.KVCacheDtype.parse(t) is t
    with pytest.raises(ValueError):
        TQ.KVCacheDtype.parse("fp4")


@pytest.mark.parametrize("arch,bs,layers,heads,hd,bf16,int8,blocks", [
    # qwen1.5-4b, 16-token blocks: the engine path's pool of 74 blocks
    ("qwen1.5-4b", 16, 40, 20, 128, 6_553_600, 3_283_200, (74, 147)),
    # the reference benchmark's kv-quant pair (benchmarks/serve_engine.py)
    ("bench", 4, 4, 4, 32, 8_192, 4_224, (41, 79)),
])
def test_kv_block_bytes_and_equal_byte_blocks(arch, bs, layers, heads, hd,
                                              bf16, int8, blocks):
    for kvd, want in (("bf16", bf16), ("int8", int8)):
        got = TQ.kv_block_bytes(bs, heads, hd, TQ.KVCacheDtype.parse(kvd),
                                n_layers=layers)
        assert got == want == RQ.kv_block_bytes(
            bs, heads, hd, RQ.KVCacheDtype.parse(kvd), n_layers=layers)
    bf16_blocks, int8_blocks = blocks
    assert bf16_blocks * bf16 // int8 == int8_blocks


# ----------------------------------------------- layers/quantized.py
def _close_act(got, want, dtype) -> None:
    """silu / gelu on each side's library function: two f32 ulps, or one
    bf16 ulp, of each element, and 1e-6 absolute near zero."""
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 2.4e-7
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)


def _ql_pair(K, N, bias=True, scale=0.2):
    w, b = _randf((K, N), scale), _randf((N,)) if bias else None
    r = RQ.quantize_linear(jnp.asarray(w),
                           None if b is None else jnp.asarray(b))
    t = TQ.quantize_linear(torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b))
    return r, t, w, b


def _acts(shape, dtype):
    x = _randf(shape)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", [None, "silu", "gelu", "relu"])
@pytest.mark.parametrize("M", [4, 40])
def test_qdense_float_out_matches_reference(dtype, activation, M):
    r, t, _, _ = _ql_pair(96, 136)
    rx, tx = _acts((M, 96), dtype)
    with r_use_context(plan_cache=RPlanCache()):
        want = RQL.qdense(rx, r, activation=activation, backend="xla")
    with t_use_context(plan_cache=TPlanCache()):
        got = TQL.qdense(tx, t, activation=activation)
        x_q, s_x = TQL.quantize_activation(tx)
    assert got.dtype == tx.dtype
    if activation in ("silu", "gelu"):
        _close_act(got, want, dtype)
    else:
        _same(got, want)
    s = RQ.absmax_scale(rx)
    _same(s_x, s)
    _same(x_q, RQ.quantize(rx, s))


@pytest.mark.parametrize("activation", [None, "relu"])
def test_qdense_int8_out_matches_reference_in_interpret_mode(activation):
    """The requantize chain (``out_qscale``), against the reference's
    Pallas kernel in interpret mode: int8 outputs exactly."""
    r, t, _, _ = _ql_pair(128, 128)
    rx, tx = _acts((32, 128), "float32")
    s_out = np.float32(0.05)
    with r_use_context(plan_cache=RPlanCache()):
        want = RQL.qdense(rx, r, activation=activation,
                          out_qscale=jnp.asarray(s_out), backend="interpret")
    with t_use_context(plan_cache=TPlanCache()):
        got = TQL.qdense(tx, t, activation=activation,
                         out_qscale=torch.tensor(s_out))
    assert got.dtype == torch.int8 and want.dtype == jnp.int8
    _same(got, want)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_qdense_rejects_non_commuting_activation_with_out_qscale(activation):
    _, t, _, _ = _ql_pair(32, 32)
    with pytest.raises(ValueError, match="out_qscale"):
        TQL.qdense(torch.ones(2, 32), t, activation=activation,
                   out_qscale=torch.tensor(0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_qdense_and_dense_dispatch_match_reference(dtype):
    w, b = _randf((96, 64), 0.1), _randf((64,))
    rx, tx = _acts((6, 96), dtype)
    with r_use_context(plan_cache=RPlanCache()):
        want = RQL.dynamic_qdense(rx, jnp.asarray(w), jnp.asarray(b),
                                  activation="silu", backend="xla")
    with t_use_context(plan_cache=TPlanCache()):
        got = TQL.dynamic_qdense(tx, torch.from_numpy(w),
                                 torch.from_numpy(b), activation="silu")
        assert tmm.launches == 0  # the CPU runs the plain version
    _close_act(got, want, dtype)
    # dense(): a float weight under quant_mode="int8" takes the dynamic
    # path, a QuantizedLinear leaf qdense with the bias given at the call
    with t_use_context(quant_mode="int8", plan_cache=TPlanCache()):
        _same(tcm.dense(tx, torch.from_numpy(w), torch.from_numpy(b),
                        activation="silu"), got)
        ql = TQ.quantize_linear(torch.from_numpy(w))
        _same(tcm.dense(tx, ql, torch.from_numpy(b), activation="silu"), got)
    with t_use_context(plan_cache=TPlanCache()):
        _same(tcm.dense(tx, ql, torch.from_numpy(b), activation="silu"), got)


@pytest.mark.parametrize("gated", [True, False])
def test_qmlp_matches_reference(gated):
    d, f = 48, 96
    mp = dict(w_in=_randf((d, f), 0.1), w_gate=_randf((d, f), 0.1)
              if gated else None, w_out=_randf((f, d), 0.1),
              b_in=_randf((f,)), b_out=_randf((d,)))
    rp = RMLP.MlpParams(**{k: None if v is None else jnp.asarray(v)
                           for k, v in mp.items()})
    tp = TMLP.MlpParams(**{k: None if v is None else torch.from_numpy(v)
                           for k, v in mp.items()})
    rq, tq = RQL.quantize_mlp(rp), TQL.quantize_mlp(tp)
    for f_ in ("w_in", "w_gate", "w_out"):
        if getattr(rq, f_) is not None:
            _same(getattr(tq, f_).w_q, getattr(rq, f_).w_q)
    rx, tx = _acts((2, 5, d), "float32")
    act = "silu" if gated else "gelu"
    with r_use_context(plan_cache=RPlanCache(), matmul_backend="xla"):
        want = RQL.qmlp(rq, rx, activation=act)
    with t_use_context(plan_cache=TPlanCache()):
        got = TQL.qmlp(tq, tx, activation=act)
    _close_act(got, want, "float32")


def test_q_self_attention_matches_reference():
    d, H, Hkv, hd = 64, 4, 2, 16
    ap = dict(wq=_randf((d, H * hd), 0.1), wk=_randf((d, Hkv * hd), 0.1),
              wv=_randf((d, Hkv * hd), 0.1), wo=_randf((H * hd, d), 0.1),
              bq=_randf((H * hd,)), bk=_randf((Hkv * hd,)),
              bv=_randf((Hkv * hd,)))
    rq = RQL.quantize_attn(RA.AttnParams(
        **{k: jnp.asarray(v) for k, v in ap.items()}))
    tq = TQL.quantize_attn(TA.AttnParams(
        **{k: torch.from_numpy(v) for k, v in ap.items()}))
    rx, tx = _acts((2, 7, d), "float32")
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd)
    with r_use_context(plan_cache=RPlanCache(), matmul_backend="xla"):
        want = RQL.q_self_attention(rq, rx, **kw)
    with t_use_context(plan_cache=TPlanCache()):
        got = TQL.q_self_attention(tq, tx, **kw)
    # the float attention core between the int8 projections: f32 order
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------- quant/prequant.py
def _cfg(arch: str, dtype: str = "float32"):
    base = dataclasses.replace(RC.smoke(RC.get_config(arch)),
                               activation_dtype=dtype)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ("qwen1.5-4b", "rwkv6-3b"):
        for dtype in ("float32", "bfloat16"):
            rcfg, tcfg = _cfg(arch, dtype)
            rp = RM.init(jax.random.PRNGKey(0), rcfg)
            tp = interop.params_from_jax(jax.tree.map(np.asarray, rp), tcfg,
                                         "cpu")
            out[arch, dtype] = (rcfg, tcfg, RP.quantize_params(rp),
                                TP.quantize_params(tp))
    return out


def _jax_items(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b"])
def test_quantize_params_matches_reference(trees, arch):
    rcfg, _, rq, tq = trees[arch, "float32"]
    want = _jax_items(rq)
    got = dict(interop.tree_items(tq))
    assert got.keys() == want.keys()
    n_q = 0
    for path, t in got.items():
        _same(t, want[path])
        n_q += t.dtype == torch.int8
    per_layer = {"dense": 7, "rwkv": 8}[rcfg.family]
    assert n_q == per_layer  # one stacked int8 leaf per projection


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b"])
def test_params_from_jax_converts_a_prequantized_tree(trees, arch):
    _, tcfg, rq, tq = trees[arch, "float32"]
    got = interop.params_from_jax(jax.tree.map(np.asarray, rq), tcfg, "cpu")
    for (p, a), (_, b) in zip(interop.tree_items(got),
                              interop.tree_items(tq)):
        assert torch.equal(a, b), p
    layer = got["layers"]["attn" if "attn" in got["layers"] else "tmix"]
    assert isinstance(layer.wk, TQ.QuantizedLinear) and layer.wk.bias is None
    # a float tree where a quantized one is due (and back) is refused
    bad = jax.tree.map(np.asarray, rq)
    lay = dict(bad["layers"])
    key = "attn" if "attn" in lay else "tmix"
    lay[key] = lay[key]._replace(wk=np.zeros((2, 64, 64), np.float32))
    with pytest.raises(ValueError, match="wk"):
        interop.params_from_jax({**bad, "layers": lay}, tcfg, "cpu")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_match_reference(trees, arch, dtype):
    """2 layers, prefill of 8 (rwkv: 32, the chunk-parallel WKV branch)
    plus 3 decode steps under ``quant_mode="int8"``: the prequantized
    projections, the dynamic unembed (and rwkv's LoRA towers)."""
    rcfg, tcfg, rq, tq = trees[arch, dtype]
    S = 32 if rcfg.family == "rwkv" else 8
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, S))
    with r_use_context(quant_mode="int8", plan_cache=RPlanCache(),
                       matmul_backend="xla"):
        st = RM.init_decode_state(rcfg, 2, S + 4)
        lg, st = RM.prefill(rq, {"tokens": jnp.asarray(toks, jnp.int32)},
                            rcfg, st)
        want = [np.asarray(lg)]
        for _ in range(3):
            nxt = want[-1][:, :rcfg.vocab_size].argmax(-1)[:, None]
            lg, st = RM.decode_step(rq, jnp.asarray(nxt, jnp.int32), rcfg, st)
            want.append(np.asarray(lg))
    with t_use_context(quant_mode="int8", plan_cache=TPlanCache()):
        st = TM.init_decode_state(tcfg, 2, S + 4, device="cpu")
        lg, st = TM.prefill(tq, {"tokens": torch.from_numpy(toks)}, tcfg, st)
        got = [lg.numpy()]
        for i in range(3):
            nxt = want[i][:, :rcfg.vocab_size].argmax(-1)[:, None]
            lg, st = TM.decode_step(tq, torch.from_numpy(nxt), tcfg, st)
            got.append(lg.numpy())
    got, want = np.stack(got), np.stack(want)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert (np.abs(got - want) / (1 + np.abs(want))).max() <= BF16_TOL


def test_int8_logits_move_by_rounding_flips_at_full_width():
    """Why the int8 path on the card is held bit for bit against its plain
    version on the card, and to a loose tolerance against the CPU: at
    qwen1.5-4b's width with 2 layers (vocabulary cut to 1024, f32
    activations), scaling the embedding by 1 + 2^-23 moves the float
    path's logits by under 1e-5 of (1 + |logit|) but the int8 path's by
    over 1e-2: an ulp-level change of a GEMM's input moves elements across
    int8 rounding boundaries, whole steps of the per-tensor grid. Two
    correct float paths (another device's summation order) differ the
    same way, so f32 activations do not bring the int8 comparison near
    the 1e-4 of the smoke-width test above."""
    cfg = dataclasses.replace(TC.get_config("qwen1.5-4b"), n_layers=2,
                              vocab_size=1024, activation_dtype="float32")
    params = TM.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 1024,
                                                              (2, 32)))
    spread = {}
    for quant in (None, "int8"):
        p = TP.quantize_params(params) if quant else params
        runs = []
        for scale in (1.0, 1.0 + 2.0 ** -23):
            with t_use_context(quant_mode=quant, plan_cache=TPlanCache()):
                st = TM.init_decode_state(cfg, 2, 40, device="cpu")
                lg, st = TM.prefill({**p, "embed": p["embed"] * scale},
                                    {"tokens": toks}, cfg, st)
                out = [lg]
                for i in range(2):
                    nxt = (runs[0][i] if runs else out[-1]).argmax(-1)
                    lg, st = TM.decode_step(
                        {**p, "embed": p["embed"] * scale}, nxt[:, None],
                        cfg, st)
                    out.append(lg)
            runs.append(out)
        a, b = torch.stack(runs[0]), torch.stack(runs[1])
        spread[quant] = ((a - b).abs() / (1 + a.abs())).max().item()
    assert spread[None] < 1e-5
    assert spread["int8"] > 1e-2


def test_int8_quant_mode_is_a_context_option():
    assert GemmContext(hw="h100", quant_mode="int8").quant_mode == "int8"
    assert GemmContext(hw="h100", quant_mode="none").quant_mode is None
    with pytest.raises(ValueError, match="quant mode"):
        GemmContext(hw="h100", quant_mode="int4")


# ----------------------------------------------- planner and launcher
def test_plan_warmup_covers_the_int8_signatures(trees):
    """``plan_model`` over a quantized tree on the meta device sees every
    int8 signature (int8 in, col layout), the dynamic unembed's included:
    serving then makes zero lazy solves."""
    _, tcfg, _, tq = trees["qwen1.5-4b", "float32"]
    cache = TPlanCache()
    with t_use_context(quant_mode="int8", plan_cache=cache):
        from repro_torch.core.gemm import plan_model

        warm = plan_model(tcfg, batch=2, prompt_len=8, max_len=12,
                          params=tq)
        before = cache.stats.snapshot()
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, tcfg.vocab_size, (2, 8)))
        out = tserve.serve_batch(tcfg, tq, prompts, gen_len=3, max_len=12)
        assert cache.stats.lazy_solves == before.lazy_solves
        assert cache.stats.misses == before.misses
    assert out.shape == (2, 3) and warm["signatures"] == warm["solved"] > 0
    # prefill M = 16 and decode M = 2: each projection and the unembed,
    # all int8 x int8 col
    keys = cache.warm_keys
    assert keys and all(k[4] == "int8" and k[6] == "col" for k in keys)


def test_serve_cli_int8_runs_in_process(capsys):
    got = tserve.main(["--smoke", "--device", "cpu", "--plan-cache", "",
                       "--quantize", "int8", "--gen", "4"])
    assert "quant=int8" in capsys.readouterr().out
    assert got["lazy_solves"] == 0 and got["misses"] == 0
    assert got["generated"].shape == (4, 4)
    assert got["quantize_s"] is not None
    assert all(0 <= int(t) < 503 for t in got["generated"].flatten())


def test_serve_cli_int8_has_no_cpu_fallback():
    """Without ``--device`` the int8 paths run on the card or raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    for extra in ([], ["--engine", "--kv-block-size", "4",
                       "--kv-quantize", "int8"]):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
             "--quantize", "int8", "--plan-cache", "", *extra],
            capture_output=True, text=True, env=env, cwd=root, timeout=300)
        assert res.returncode != 0 and "CUDA" in res.stderr
