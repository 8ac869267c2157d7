"""Decoder-only LM, dense, MoE, RWKV-6 and Mamba2-hybrid families (port
of ``repro.models.lm``).

Parameters are the reference's tree: plain dicts and NamedTuples, layers
stacked on a leading L axis. ``lax.scan`` over layers becomes a Python loop
over views of the stacked leaves (the hybrid family's ``lax.cond`` on the
layer index a Python ``if``); the decode state (the KV cache of the dense
and MoE families (L, B, S_max, Hkv, Dh) or paged pool (L, blocks, block,
Hkv, Dh) with its int32 lengths and block table, the rwkv WKV state (L, B,
H, N, N) and token shifts (L, B, d), or the hybrid's SSM state (L, B, H,
P, N), conv inputs (L, B, 3, d_conv) and the shared block's KV cache) is
written in place, lengths included, the counterpart of the reference's
``donate_argnums``: a step captured as a CUDA graph keeps writing the same
buffers.

Entry points: init_lm, forward, lm_loss, init_decode_state, prefill,
prefill_chunk, decode_step, verify_step. ``forward`` and ``lm_loss`` are the
training path: under grad each layer (with ``cfg.remat``) and each loss
chunk is recomputed in the backward, as the reference's ``jax.checkpoint``
does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as cd
from repro_torch.core.gemm import checkpointed
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import mamba as mb
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import rwkv as rwkv_lib
from repro_torch.quant.kvcache import KVCacheDtype

FAMILIES = ("dense", "moe", "rwkv", "hybrid")
# the families the engine serves (per-slot and paged states, chunked
# prefill, verify); the hybrid family's shared block has a KV cache too,
# but it serves through the static server only, as in the reference
KV_FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not an LM family of the port "
            f"({FAMILIES})")


# ---------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, d: int, *, lead=(), device):
    ones = torch.ones((*lead, d), dtype=cfg.pdtype, device=device)
    if cfg.norm_type == "layernorm":
        return {"g": ones, "b": torch.zeros_like(ones)}
    return {"g": ones}


def norm_axes(cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return {"g": ("embed",), "b": ("embed",)}
    return {"g": ("embed",)}


def is_axes_leaf(a) -> bool:
    """An axes leaf is a plain tuple of axis names (str/None). None is NOT a
    leaf: like an absent (None) param it is an empty subtree, so axes trees
    walk in lockstep with param trees. NamedTuple containers are tuple
    subclasses, excluded by the ``type() is tuple`` check."""
    return type(a) is tuple and all(x is None or isinstance(x, str) for x in a)


def _prefix_axes(tree, prefix: str = "layers"):
    """Every axes leaf of ``tree`` with ``prefix`` in front (a stacked
    leaf's leading L dim)."""
    if tree is None:
        return None
    if is_axes_leaf(tree):
        return (prefix, *tree)
    if isinstance(tree, dict):
        return {k: _prefix_axes(v, prefix) for k, v in tree.items()}
    return type(tree)(*(_prefix_axes(v, prefix) for v in tree))


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "layernorm":
        return cm.layer_norm(x, p["g"], p["b"], cfg.norm_eps)
    return cm.rms_norm(x, p["g"], cfg.norm_eps)


# ---------------------------------------------------------------- init
def init_lm(cfg: ModelConfig, *, seed: int = 0, device) -> dict[str, Any]:
    """Random weights with the reference's tree, shapes and dtypes, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    values differ from ``jax.random``'s; ``interop.params_from_jax`` carries
    reference weights over instead)."""
    cfg.validate()
    _check_family(cfg)
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, dt, L = cfg.d_model, cfg.pdtype, cfg.n_layers
    Vp = cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": cm.normal_init(gen, (Vp, d), dt, scale=0.02, device=device),
        "final_norm": init_norm(cfg, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = cm.normal_init(gen, (d, Vp), dt, device=device)
    layers = {
        "ln1": init_norm(cfg, d, lead=(L,), device=device),
        "ln2": init_norm(cfg, d, lead=(L,), device=device),
    }
    if cfg.family == "hybrid":
        # the stacked Mamba layers, and one shared attention + MLP block
        # (zamba2) that every shared_attn_every-th layer calls
        params["layers"] = {
            "ln1": layers["ln1"],
            "mamba": mb.init_mamba(
                gen, d, cfg.ssm_state, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim, dtype=dt, lead=(L,),
                device=device),
        }
        params["shared"] = {
            "ln1": init_norm(cfg, d, device=device),
            "ln2": init_norm(cfg, d, device=device),
            "attn": attn.init_attn(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                qkv_bias=cfg.qkv_bias, dtype=dt, device=device),
            "mlp": mlp_lib.init_mlp(gen, d, cfg.d_ff, gated=cfg.gated_mlp,
                                    dtype=dt, device=device),
        }
        return params
    if cfg.family == "rwkv":
        layers["tmix"] = rwkv_lib.init_time_mix(gen, d, dtype=dt, lead=(L,),
                                                device=device)
        layers["cmix"] = rwkv_lib.init_channel_mix(
            gen, d, cfg.d_ff, dtype=dt, lead=(L,), device=device)
    else:
        layers["attn"] = attn.init_attn(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=(L,), device=device)
        if cfg.family == "moe":
            layers["moe"] = moe_lib.init_moe(
                gen, d, cfg.d_ff, cfg.n_experts, gated=cfg.gated_mlp,
                dtype=dt, lead=(L,), device=device)
        if cfg.family == "dense" or cfg.dense_residual:
            # arctic's dense_residual: a dense FFN beside the experts
            layers["mlp"] = mlp_lib.init_mlp(
                gen, d, cfg.d_ff, gated=cfg.gated_mlp, bias=False, dtype=dt,
                lead=(L,), device=device)
    params["layers"] = layers
    return params


def lm_axes(cfg: ModelConfig):
    """The logical sharding axes of :func:`init_lm`'s tree, leaf for leaf
    (the reference's ``lm_axes``)."""
    _check_family(cfg)
    ax: dict[str, Any] = {
        "embed": ("vocab", None),
        "final_norm": norm_axes(cfg),
    }
    if not cfg.tie_embeddings:
        ax["unembed"] = (None, "vocab")
    if cfg.family in ("dense", "moe"):
        layers = {
            "ln1": _prefix_axes(norm_axes(cfg)),
            "ln2": _prefix_axes(norm_axes(cfg)),
            "attn": _prefix_axes(attn.attn_axes(cfg.qkv_bias)),
        }
        if cfg.family == "dense":
            layers["mlp"] = _prefix_axes(mlp_lib.mlp_axes(cfg.gated_mlp))
        else:
            layers["moe"] = _prefix_axes(moe_lib.moe_axes(cfg.gated_mlp))
            if cfg.dense_residual:
                layers["mlp"] = _prefix_axes(mlp_lib.mlp_axes(cfg.gated_mlp))
        ax["layers"] = layers
    elif cfg.family == "rwkv":
        ax["layers"] = {
            "ln1": _prefix_axes(norm_axes(cfg)),
            "ln2": _prefix_axes(norm_axes(cfg)),
            "tmix": _prefix_axes(rwkv_lib.time_mix_axes()),
            "cmix": _prefix_axes(rwkv_lib.channel_mix_axes()),
        }
    else:  # hybrid
        ax["layers"] = {
            "ln1": _prefix_axes(norm_axes(cfg)),
            "mamba": _prefix_axes(mb.mamba_axes()),
        }
        ax["shared"] = {
            "ln1": norm_axes(cfg), "ln2": norm_axes(cfg),
            "attn": attn.attn_axes(cfg.qkv_bias),
            "mlp": mlp_lib.mlp_axes(cfg.gated_mlp),
        }
    return ax


def _layer(layers, i: int):
    """Layer ``i`` of the stacked layer tree (views, no copies)."""
    return interop.tree_map(lambda t: t[i], layers)


def _unstack(layers, n: int) -> list:
    """The stacked layer tree as ``n`` per-layer trees of views, by one
    ``unbind(0)`` per leaf. Under autograd the gradient of a leaf is then
    stacked once (``UnbindBackward0``), where ``t[i]`` per layer writes a
    zero tensor the size of the whole stack for every layer."""
    split = interop.tree_map(lambda t: t.unbind(0), layers)
    return [interop.tree_map(lambda parts: parts[i], split)
            for i in range(n)]


def _remat(cfg: ModelConfig, fn):
    """The reference's ``_maybe_remat``: with ``cfg.remat`` and grad on,
    ``fn`` is ``core.gemm.checkpointed`` under ``cfg.remat_policy`` ("full"
    or "dots")."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return checkpointed(fn, cfg.remat_policy)


def _attn_kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                chunk=cfg.attn_chunk)


def _heads_kw(cfg: ModelConfig):
    """The model's head counts, which a cache block under tensor
    parallelism does not show."""
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim)


def _embed(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    return cm.embed_lookup(params["embed"], tokens).to(cfg.dtype)


def _ffn_aux(cfg: ModelConfig, lp, x, token_mask=None):
    """The block's FFN on ln2(x): (y, the MoE layer's aux loss or None).
    ``token_mask`` marks the live tokens that compete for expert capacity
    (None: every token)."""
    h = apply_norm(cfg, lp["ln2"], x)
    if cfg.family != "moe":
        return mlp_lib.mlp(lp["mlp"], h, activation=cfg.activation), None
    y, aux = moe_lib.moe_ffn(
        lp["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        activation=cfg.activation, token_mask=token_mask)
    if cfg.dense_residual:
        y = y + mlp_lib.mlp(lp["mlp"], h, activation=cfg.activation)
    return y, aux


def _ffn(cfg: ModelConfig, lp, x, token_mask=None):
    return _ffn_aux(cfg, lp, x, token_mask)[0]


def _rwkv_block(cfg: ModelConfig, lp, x, prev=None):
    """Returns (x, (wkv state, time-mix shift, channel-mix shift)) in the
    layout the layers compute with (``rwkv.time_mix``). ``prev``: the
    layer's views of the decode state (wkv, att_shift, ffn_shift) as this
    rank holds them (``decode_state_specs``), read into that layout."""
    tmix_state, shifts = None, (None, None)
    if prev is not None:
        B, d, H = x.shape[0], cfg.d_model, cfg.n_heads
        N = d // H
        local = H // rwkv_lib.tp_extent(lp["tmix"], H)
        tmix_state = cm.relayout(prev[0], (B, H, N, N), (B, local, N, N))
        shifts = tuple(cm.relayout(t, (B, d), (B, d)) for t in prev[1:])
    h = apply_norm(cfg, lp["ln1"], x)
    y, (new_state, last_att) = rwkv_lib.time_mix(
        lp["tmix"], h, n_heads=cfg.n_heads, state=tmix_state,
        x_prev=shifts[0])
    x = x + y
    h2 = apply_norm(cfg, lp["ln2"], x)
    y2, last_ffn = rwkv_lib.channel_mix(lp["cmix"], h2, x_prev=shifts[1])
    return x + y2, (new_state, last_att, last_ffn)


def _shared_block(cfg: ModelConfig, sp, x, cache=None, mode: str = "full"):
    """The hybrid family's shared attention + MLP block. ``mode``: "full"
    (no cache), "prefill" or "decode" (``cache``, one layer's KVCache view,
    written in place)."""
    h = apply_norm(cfg, sp["ln1"], x)
    if mode == "full":
        y = attn.self_attention(sp["attn"], h, **_attn_kw(cfg))
    elif mode == "prefill":
        y, _ = attn.prefill_attention(sp["attn"], h, cache,
                                      rope_theta=cfg.rope_theta,
                                      chunk=cfg.attn_chunk, **_heads_kw(cfg))
    else:
        y, _ = attn.decode_attention(sp["attn"], h, cache,
                                     rope_theta=cfg.rope_theta,
                                     **_heads_kw(cfg))
    x = x + y
    return x + mlp_lib.mlp(sp["mlp"], apply_norm(cfg, sp["ln2"], x),
                           activation=cfg.activation)


def _hybrid_layer(params, cfg: ModelConfig, i: int, x, state=None,
                  mode: str = "full", lp=None):
    """Layer ``i`` of the hybrid stack: its Mamba block, then the shared
    block where ``i % shared_attn_every == 0``. With ``state`` (prefill:
    the Mamba block starts from zeros; decode: from the state) the layer's
    SSM state and conv inputs are written back in place, in the layout
    this rank holds them (``decode_state_specs``; ``layers.common.
    relayout``), and the shared block's K/V go to layer i's slot of the
    cache; the other slots are left as they are. ``lp``: layer ``i``'s
    tree, if already taken."""
    if lp is None:
        lp = cm.gathered(_layer(params["layers"], i))
    B = x.shape[0]
    d_inner, H = mb.dims(cfg.d_model, cfg.ssm_state, expand=cfg.ssm_expand,
                         head_dim=cfg.ssm_head_dim)
    full = {"ssm": (B, H, cfg.ssm_head_dim, cfg.ssm_state),
            "conv": (B, mb.CONV_K - 1, d_inner + 2 * cfg.ssm_state)}
    prev = None
    if mode == "decode":
        local = dict(full, ssm=(B, H // mb.tp_extent(lp["mamba"], H),
                                *full["ssm"][2:]))
        prev = mb.MambaState(**{k: cm.relayout(state[k][i], full[k],
                                               local[k]) for k in full})
    y, new = mb.mamba_block(
        lp["mamba"], apply_norm(cfg, lp["ln1"], x), d_state=cfg.ssm_state,
        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, state=prev,
        state_out=state is not None)
    x = x + y
    if state is not None:
        for k in full:
            dst = state[k][i]
            dst.copy_(cm.relayout(getattr(new, k), full[k], dst.shape))
    if i % (cfg.shared_attn_every or cfg.n_layers + 1) == 0:
        cache = None
        if state is not None:
            kv = state["kv"]
            cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
        x = _shared_block(cfg, params["shared"], x, cache, mode)
    return x


def _hybrid_layers(params, cfg: ModelConfig, x, state=None,
                   mode: str = "full"):
    """The hybrid stack, :func:`_hybrid_layer` by layer."""
    for i in range(cfg.n_layers):
        x = _hybrid_layer(params, cfg, i, x, state, mode)
    return x


def _write_rwkv_state(cfg: ModelConfig, state, i: int, new) -> None:
    """Layer ``i``'s new (wkv, att_shift, ffn_shift), as ``_rwkv_block``
    computed them, into the stacked decode state in place, in the layout
    this rank holds it (``layers.common.relayout``)."""
    B, d, H = new[1].shape[0], cfg.d_model, cfg.n_heads
    N = d // H
    for key, t, full in zip(("wkv", "att_shift", "ffn_shift"), new,
                            ((B, H, N, N), (B, d), (B, d))):
        dst = state[key][i]
        dst.copy_(cm.relayout(t, full, dst.shape))


# ---------------------------------------------------------------- forward
def _block(cfg: ModelConfig, lp, x):
    """One dense or MoE layer: (x, the MoE layer's aux loss or None)."""
    x = x + attn.self_attention(lp["attn"], apply_norm(cfg, lp["ln1"], x),
                                **_attn_kw(cfg))
    y, a = _ffn_aux(cfg, lp, x)
    return x + y, a


def forward(params, tokens, cfg: ModelConfig):
    """tokens (B, S) -> (hidden (B, S, d), aux_loss scalar)."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # a sharded step's plan gathers each layer's slice inside the remat
    # boundary (cm.gathered), so the recompute gathers it again
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, lp in enumerate(layers):
        if cfg.family == "hybrid":
            x = _remat(cfg, lambda x, lp, i=i: _hybrid_layer(
                params, cfg, i, x, None, "full", cm.gathered(lp)))(x, lp)
        elif cfg.family == "rwkv":
            x = _remat(cfg, lambda x, lp: _rwkv_block(
                cfg, cm.gathered(lp), x)[0])(x, lp)
        else:
            x, a = _remat(cfg, lambda x, lp: _block(
                cfg, cm.gathered(lp), x))(x, lp)
            if a is not None:
                aux = aux + a
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.family == "moe":
        aux = aux / cfg.n_layers
    return x, aux


def _unembed(params, cfg: ModelConfig):
    """(the unembedding table, its layout): tied embeddings use the (V, d)
    table as a column-major B."""
    if cfg.tie_embeddings:
        return params["embed"], "col"
    return params["unembed"], "row"


def _logits(params, cfg: ModelConfig, h, *, vocab_block: bool = False):
    """Unembed, (..., Vp) f32. Under a tensor-parallel plan whose 'model'
    blocks split the vocabulary the product is column-parallel: this
    rank's (..., Vp / tp) block with ``vocab_block``, else the blocks
    gathered (every rank then takes the same argmax)."""
    table, layout = _unembed(params, cfg)
    if cm.block_dim(table) is None:
        if layout == "col":
            return cm.balanced_gemm(h, table, b_layout="col",
                                    out_dtype=torch.float32)
        return cm.dense(h, table, out_dtype=torch.float32)
    mesh = cm.tp_mesh()
    logits = cd.column_parallel(h, table, mesh=mesh, out_dtype=torch.float32,
                                b_layout=layout)
    return logits if vocab_block else cd.gather_from_model(logits, mesh, -1)


def _chunk_nll(params, cfg: ModelConfig, h, lab):
    """One loss chunk: (the sum of its tokens' NLL, its live-label count).
    Vocab-parallel under a tensor-parallel plan: each rank's logsumexp over
    its block, all-gathered and combined; the gold logit from the rank that
    owns the label, summed over 'model'. The loss is then the same number
    on every rank of 'model'."""
    logits = _logits(params, cfg, h, vocab_block=True)
    mask = (lab >= 0) & (lab < cfg.vocab_size)
    lab_c = lab.clamp(0, cfg.padded_vocab - 1).long()
    if logits.shape[-1] == cfg.padded_vocab:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab_c[..., None])[..., 0]
    else:
        mesh = cm.tp_mesh()
        n = logits.shape[-1]
        local = lab_c - mesh.axis_index("model") * n
        own = (local >= 0) & (local < n)
        parts = cd.gather_from_model(
            torch.logsumexp(logits, dim=-1)[..., None], mesh, -1)
        lse = torch.logsumexp(parts, dim=-1)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        gold = cd.reduce_from_model(
            torch.where(own, gold[..., 0], torch.zeros_like(gold[..., 0])),
            mesh)
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum(dtype=torch.int32)


def lm_loss(params, hidden, labels, cfg: ModelConfig):
    """Sequence-chunked CE: logits exist (B, chunk, Vp) at a time, each
    chunk recomputed in the backward (the reference's ``jax.checkpoint``
    of its scan body). Labels outside [0, vocab) are masked out."""
    B, S, d = hidden.shape
    c = min(cfg.loss_chunk, S)
    if S % c:
        c = S  # fallback: uneven chunks
    body = lambda h, lab: _chunk_nll(params, cfg, h, lab)
    if torch.is_grad_enabled():
        body = checkpointed(body)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for j in range(0, S, c):
        nll, n = body(hidden[:, j:j + c], labels[:, j:j + c])
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp_min(cnt, 1)


# ---------------------------------------------------------------- decode
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      per_slot: bool = False,
                      kv_block_size: int | None = None,
                      num_kv_blocks: int | None = None, kv_dtype=None,
                      device):
    """dense and moe: contiguous KV cache (L, B, max_len, Hkv, Dh) in the
    activation dtype with an int32 length, 0-d (one for every row) or,
    ``per_slot``, (B,) (the engine's lanes). ``kv_block_size`` switches the
    per-slot cache to the paged pool: ``num_kv_blocks`` blocks of
    ``kv_block_size`` tokens (block 0 the null block) and a (B,
    ceil(max_len / block)) table. ``kv_dtype`` (a :class:`KVCacheDtype` or
    its name) ``"int8"`` stores the pool in int8 with (L, num_kv_blocks,
    Hkv) f32 scales of 1.0: the paged layout only. rwkv: the WKV state (L,
    B, H, N, N) f32 and the token shifts (L, B, d) in the activation dtype;
    ``max_len`` does not bound it. hybrid: the SSM state (L, B, H, P, N)
    f32, the conv inputs (L, B, 3, d_conv) in the activation dtype, and the
    contiguous KV cache over all L layers with a 0-d length (only the
    shared block's layers write theirs)."""
    _check_family(cfg)
    L, d = cfg.n_layers, cfg.d_model
    kvd = KVCacheDtype.parse(kv_dtype)
    if kvd.quantized and not kv_block_size:
        raise ValueError(
            f"kv_dtype={kvd.value} needs the paged layout (kv_block_size)")
    if kv_block_size:
        if cfg.family not in KV_FAMILIES:
            raise ValueError(
                f"paged KV needs a KV-cache family, not {cfg.family!r}")
        if not per_slot:
            raise ValueError("paged KV is a per-slot (engine) layout")
        if num_kv_blocks is None or num_kv_blocks < 2:
            raise ValueError(
                f"paged KV needs num_kv_blocks >= 2 (block 0 is the null "
                f"block), got {num_kv_blocks}")
        return {"kv": attn.init_paged_kv_cache(
            batch, num_kv_blocks, kv_block_size, -(-max_len // kv_block_size),
            cfg.n_kv_heads, cfg.head_dim, cfg.dtype, kv_dtype=kvd, lead=(L,),
            device=device)}
    if per_slot and cfg.family not in KV_FAMILIES:
        raise ValueError("per-slot decode state needs a KV-cache family, "
                         f"not {cfg.family!r}")
    if cfg.family == "rwkv":
        H = cfg.n_heads
        N = d // H
        return {
            "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                               device=device),
            "att_shift": torch.zeros((L, batch, d), dtype=cfg.dtype,
                                     device=device),
            "ffn_shift": torch.zeros((L, batch, d), dtype=cfg.dtype,
                                     device=device),
        }
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    state = {"kv": attn.KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device))}
    if cfg.family == "hybrid":
        d_inner, n_heads = mb.dims(d, cfg.ssm_state, expand=cfg.ssm_expand,
                                   head_dim=cfg.ssm_head_dim)
        state["ssm"] = torch.zeros(
            (L, batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device)
        state["conv"] = torch.zeros(
            (L, batch, mb.CONV_K - 1, d_inner + 2 * cfg.ssm_state),
            dtype=cfg.dtype, device=device)
    return state


def _at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) at position ``pos`` (0-d, or (B,)) of each row:
    (B, 1, d), a gather with a device index."""
    idx = pos.reshape(-1, 1, 1).long().expand(x.shape[0], 1, x.shape[2])
    return torch.gather(x, 1, idx)


def prefill(params, tokens, cfg: ModelConfig, state, last_pos=None):
    """Full-sequence prefill populating the decode state in place.

    Returns (last-token logits (B, Vp) f32, state). ``last_pos`` (0-d or
    (B,) int tensor) selects the position whose logits are returned
    instead of the last: the contiguous engine right-pads every prompt to
    one length and reads each request's true last token. The rwkv family
    starts from zero state whatever ``state`` holds, as the reference's
    does, and overwrites it; so do the hybrid family's Mamba blocks."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    if cfg.family == "rwkv":
        for i in range(cfg.n_layers):
            x, new = _rwkv_block(cfg, cm.gathered(_layer(params["layers"], i)),
                                 x)
            _write_rwkv_state(cfg, state, i, new)
    elif cfg.family == "hybrid":
        x = _hybrid_layers(params, cfg, x, state, mode="prefill")
        state["kv"].length.fill_(tokens.shape[1])
    else:
        S = tokens.shape[1]
        kv = state["kv"]
        for i in range(cfg.n_layers):
            lp = cm.gathered(_layer(params["layers"], i))
            h = apply_norm(cfg, lp["ln1"], x)
            cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
            y, _ = attn.prefill_attention(lp["attn"], h, cache,
                                          rope_theta=cfg.rope_theta,
                                          chunk=cfg.attn_chunk,
                                          **_heads_kw(cfg))
            x = x + y
            x = x + _ffn(cfg, lp, x)
        kv.length.fill_(S)
    h_last = x[:, -1:] if last_pos is None else _at(x, last_pos)
    h_last = apply_norm(cfg, params["final_norm"], h_last)
    return _logits(params, cfg, h_last)[:, 0], state


def _paged_layer(kv: attn.PagedKVCache, i: int) -> attn.PagedKVCache:
    """Layer ``i``'s views of the stacked pool (and its scales, int8)."""
    at = lambda t: None if t is None else t[i]
    return kv._replace(k=kv.k[i], v=kv.v[i], k_scale=at(kv.k_scale),
                       v_scale=at(kv.v_scale))


def prefill_chunk(params, tokens, cfg: ModelConfig, state, *, slot, start,
                  true_len, blocks):
    """One chunked-prefill step into a paged decode state, in place.

    ``tokens`` (1, C): the next chunk of one request's prompt, right-padded
    to the bucket C. 0-d int tensors: ``slot`` (the lane), ``start``
    (tokens earlier chunks wrote), ``true_len`` (real tokens in this
    chunk); ``blocks`` (max_blocks,) is the lane's block-table row,
    installed on every chunk (idempotent). Returns (logits (1, Vp) at the
    chunk's last real token, state). Every position is a tensor, so one
    captured graph per bucket serves every admission."""
    _check_family(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(
            f"chunked prefill needs a KV-cache family, not {cfg.family!r}")
    kv = state["kv"]
    if not isinstance(kv, attn.PagedKVCache):
        raise ValueError("prefill_chunk requires a paged decode state "
                         "(init_decode_state with kv_block_size)")
    lane = slot.reshape(1).long()
    kv.table.index_copy_(0, lane, blocks.reshape(1, -1).to(kv.table.dtype))
    x = _embed(params, tokens, cfg)
    # pad positions must not compete for expert capacity
    live = ((torch.arange(tokens.shape[1], device=x.device) < true_len)[None]
            if cfg.family == "moe" else None)
    for i in range(cfg.n_layers):
        lp = cm.gathered(_layer(params["layers"], i))
        h = apply_norm(cfg, lp["ln1"], x)
        y, _ = attn.paged_prefill_attention(
            lp["attn"], h, _paged_layer(kv, i), slot=slot, start=start,
            true_len=true_len, rope_theta=cfg.rope_theta, **_heads_kw(cfg))
        x = x + y
        x = x + _ffn(cfg, lp, x, live)
    kv.length.index_copy_(0, lane,
                          (start + true_len).reshape(1).to(kv.length.dtype))
    h_last = apply_norm(cfg, params["final_norm"], _at(x, true_len - 1))
    return _logits(params, cfg, h_last)[:, 0], state


def decode_step(params, tokens, cfg: ModelConfig, state, active=None):
    """One decode step. tokens (B, 1) -> (logits (B, Vp) f32, state).

    ``active`` (B,) int marks the live lanes of a per-slot state: an
    inactive lane's length does not advance, and under MoE its token takes
    no expert capacity (the KV-cache families only, as in the reference's
    engine). The lengths advance in place."""
    _check_family(cfg)
    if active is not None and cfg.family not in KV_FAMILIES:
        raise ValueError(
            f"per-slot active masks need a KV-cache family, not {cfg.family!r}")
    x = _embed(params, tokens, cfg)
    if cfg.family == "rwkv":
        for i in range(cfg.n_layers):
            x, new = _rwkv_block(
                cfg, cm.gathered(_layer(params["layers"], i)), x,
                prev=tuple(state[k][i] for k in ("wkv", "att_shift",
                                                  "ffn_shift")))
            _write_rwkv_state(cfg, state, i, new)
        h = apply_norm(cfg, params["final_norm"], x)
        return _logits(params, cfg, h)[:, 0], state
    kv = state["kv"]
    paged = isinstance(kv, attn.PagedKVCache)
    live = ((active > 0)[:, None]
            if active is not None and cfg.family == "moe" else None)
    if cfg.family == "hybrid":
        x = _hybrid_layers(params, cfg, x, state, mode="decode")
    else:
        for i in range(cfg.n_layers):
            lp = cm.gathered(_layer(params["layers"], i))
            h = apply_norm(cfg, lp["ln1"], x)
            if paged:
                y, _ = attn.paged_decode_attention(
                    lp["attn"], h, _paged_layer(kv, i),
                    rope_theta=cfg.rope_theta, active=active,
                    **_heads_kw(cfg))
            else:
                cache = attn.KVCache(k=kv.k[i], v=kv.v[i],
                                     length=kv.length)
                y, _ = attn.decode_attention(lp["attn"], h, cache,
                                             rope_theta=cfg.rope_theta,
                                             **_heads_kw(cfg))
            x = x + y
            x = x + _ffn(cfg, lp, x, live)
    kv.length.add_(1 if active is None else active.to(kv.length.dtype))
    h = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], state


def verify_step(params, tokens, cfg: ModelConfig, state, active=None):
    """Speculative-verify step: S candidate tokens a lane in one pass, into
    a paged decode state, in place.

    ``tokens`` (B, S): per lane, the last committed token followed by the
    draft's S - 1 proposals. Returns (logits (B, S, Vp) f32 at every fed
    position, state): the engine's greedy acceptance compares each
    proposal with the target's own argmax at the same position. All S
    keys and values are written through the block table
    (``attn.paged_verify_attention``) and every active lane's length
    advances by S in place; the engine rewinds the rejected tail (blocks
    were allocated at budget, so a rewind never touches the allocator).
    Under MoE a live lane's S tokens are all real, and a vacant lane's take
    no expert capacity (``active`` broadcast over the S positions; over DP
    every lane's, of which ``moe_ffn`` takes this rank's). rwkv has no KV
    cache to verify against."""
    _check_family(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(
            f"speculative verify needs a KV-cache family, not {cfg.family!r}")
    kv = state["kv"]
    if not isinstance(kv, attn.PagedKVCache):
        raise ValueError("verify_step requires a paged decode state "
                         "(init_decode_state with kv_block_size)")
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    live = ((active > 0)[:, None].expand(-1, S)
            if active is not None and cfg.family == "moe" else None)
    for i in range(cfg.n_layers):
        lp = cm.gathered(_layer(params["layers"], i))
        h = apply_norm(cfg, lp["ln1"], x)
        y, _ = attn.paged_verify_attention(
            lp["attn"], h, _paged_layer(kv, i), rope_theta=cfg.rope_theta,
            active=active, **_heads_kw(cfg))
        x = x + y
        x = x + _ffn(cfg, lp, x, live)
    kv.length.add_(S if active is None else S * active.to(kv.length.dtype))
    h = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h), state
