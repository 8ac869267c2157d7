"""Serving step factories (port of ``repro.train.servestep``): the static
server's decode, the continuous-batching engine's decode tick, admit and
chunked prefill, and speculative decoding's verify, draft admit and
propose.

The reference compiles each step with ``jax.jit`` and donates the state;
here each ``*_fn`` is a :class:`repro_torch.train.graphs.CapturedStep`:
one CUDA graph per shape bucket on the card, replayed over the state's own
buffers, and the raw step on the CPU. The ``*_raw`` callables are the
steps themselves; the engine's plan warm-up runs them on the meta device.
Slot, chunk start, true length and the block-table row are device
tensors, not Python numbers: admissions and chunk progress replay the
same graph.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context, use_context
from repro_torch.interop import tree_items, tree_map_with_path
from repro_torch.models.lm import KV_FAMILIES
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as shd
from repro_torch.train.graphs import CapturedStep

@dataclasses.dataclass
class ServeArtifacts:
    """``decode_fn(params, state, tokens)``: one (batch, 1) decode step,
    captured; ``prefill_fn(params, state, batch)``: the whole-prompt
    prefill of ``batch`` ({'tokens': (B, P)} plus the family's extras,
    ``prefill_input_shapes``), eager (it runs once a batch). Both return
    the logits whole over the vocabulary.

    Over a ``mesh`` the params are this rank's blocks (``param_specs``,
    :meth:`shard_params`), the decode state too (``decode_state_specs``,
    :meth:`init_state`) and the batch this rank's rows over the DP axes
    (:meth:`rows`); ``layout`` is the steps' layout over it, the decode
    state's that of the batch and ``max_len`` the steps were made for."""

    decode_fn: Callable
    prefill_fn: Callable
    decode_raw: Callable
    mesh: Any = None
    param_specs: Any = None
    cfg: ModelConfig | None = None
    device: Any = None
    layout: _Layout | None = None

    def shard_params(self, params):
        """This rank's blocks of a whole parameter tree."""
        if self.mesh is None:
            return params
        return shd.shard_tree(params, self.param_specs, self.mesh)

    def init_state(self, batch: int, max_len: int):
        """The decode state of ``batch`` rows: over a mesh this rank's
        blocks of it, allocated as such, of the batch and ``max_len`` the
        steps were made for (a family without a KV cache: any)."""
        if self.mesh is None:
            return models.init_decode_state(self.cfg, batch, max_len,
                                            device=self.device)
        full = models.init_decode_state(self.cfg, batch, max_len,
                                        device="meta")
        self.layout.check_whole(full)
        return dataclasses.replace(
            self.layout, whole=full, state_specs=shd.decode_state_specs(
                full, self.cfg, self.mesh)).init_state(self.device)

    def rows(self, batch: dict) -> dict:
        """This rank's rows of a prefill batch (``batch_specs``). The moe
        family needs them split: expert parallelism runs over the DP
        ranks' rows, as the reference's ``shard_map`` does."""
        if self.mesh is None:
            return batch
        specs = shd.batch_specs(batch, self.mesh)
        dp = math.prod(self.mesh.axis_size(a) for a in self.mesh.dp_axes())
        if self.cfg.family == "moe" and dp > 1 and not shd.is_sharded(
                next(iter(specs.values())), self.mesh):
            raise ValueError(
                f"the moe family over a mesh splits the batch over the DP "
                f"axes (expert parallelism): their extent {dp} must divide "
                f"the batch of {next(iter(batch.values())).shape[0]}")
        return {k: shd.shard_leaf(v, specs[k], self.mesh)
                for k, v in batch.items()}


def make_serve_step(cfg: ModelConfig, *, device, mesh=None,
                    quantized: bool = False, batch: int | None = None,
                    max_len: int | None = None) -> ServeArtifacts:
    """The static-batch server's steps, for every ported family; over a
    ``mesh`` sharded: each step runs under the mesh and a
    ``parallel.fsdp.ShardPlan`` in ``no_grad``, the layers' leaves
    gathered over the DP axes, tensor-parallel over 'model' (attention,
    the MLPs, RWKV-6's time-mix and channel-mix, Mamba-2's heads), the MoE
    expert tables this rank's blocks (expert parallelism), the decode
    state this rank's blocks (``decode_state_specs`` of a state of
    ``batch`` rows and ``max_len`` positions, as the reference's
    ``make_serve_step`` takes them; a family with a KV cache needs them
    over a mesh: its cache's layout follows them), which the layers read
    and write in their own layout. A mesh with an axis above 1 runs the
    decode step eager (a CUDA graph cannot capture a ``gloo``
    collective); a 1 x 1 mesh keeps the captured step. ``quantized``: the
    params are ``quant.prequant.quantize_params``' tree (its specs follow
    ``quantize_axes``); every family serves int8 over any mesh."""

    def decode(params, state, tokens):
        return models.decode_step(params, tokens, cfg, state)[0]

    def prefill(params, state, batch):
        return models.prefill(params, batch, cfg, state)[0]

    if mesh is None:
        return ServeArtifacts(decode_fn=CapturedStep(decode, device),
                              prefill_fn=prefill, decode_raw=decode,
                              cfg=cfg, device=device)
    whole = None if max_len is None else models.init_decode_state(
        cfg, batch, max_len, device="meta")
    lay = _layout(cfg, mesh, whole, quantized=quantized)
    decode_raw = _sharded(lay, decode, state_of=True)
    eager = any(n > 1 for n in mesh.shape)
    return ServeArtifacts(
        decode_fn=decode_raw if eager else CapturedStep(decode_raw, device),
        prefill_fn=_sharded(lay, prefill, state_of=True),
        decode_raw=decode_raw, mesh=mesh, param_specs=lay.param_specs,
        cfg=cfg, device=device, layout=lay)


def prefill_input_shapes(cfg: ModelConfig, batch: int, seq: int
                         ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The static server's prefill batch: each input's (shape, dtype).
    encdec adds the frontend stub's frame embeddings and vlm the vision
    stub's patch embeddings, as in the reference."""
    out = {"tokens": ((batch, seq), torch.int64)}
    if cfg.family == "encdec":
        out["frames"] = ((batch, cfg.encoder_len, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        out["image_embeds"] = ((batch, cfg.n_image_tokens, cfg.d_model),
                               cfg.dtype)
    return out


def param_blocks(cfg: ModelConfig, params, mesh, *,
                 quantized: bool = False):
    """This rank's blocks of a whole parameter tree of ``cfg`` over
    ``mesh`` (``quantized``: ``quantize_params``' tree), laid out as every
    step over the mesh keeps them (``param_specs``)."""
    return _layout(cfg, mesh, None, quantized=quantized).shard_params(params)


def _check_engine_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in KV_FAMILIES:
        raise ValueError(
            f"the {what} needs a KV-cache family {KV_FAMILIES}, got "
            f"{cfg.family!r}")


@dataclasses.dataclass
class _Layout:
    """A step's params and state over a mesh: the params' specs and the
    shard plan the steps run under (its ``kv`` the state's K leaf spec),
    the state's specs and its whole shapes (meta; None for a static
    server made without a batch and ``max_len``)."""

    mesh: Any
    param_specs: Any
    plan: fsdp.ShardPlan
    stacked: set
    state_specs: Any
    whole: Any

    def init_state(self, device):
        """This rank's blocks of the state, zeros (an int8 pool's scales
        1.0), allocated as such."""
        spec_of = dict(tree_items(self.state_specs))

        def block(path, t):
            shape = shd.local_shape(tuple(t.shape), spec_of[path], self.mesh)
            if path.endswith("_scale"):
                return torch.ones(shape, dtype=t.dtype, device=device)
            return torch.zeros(shape, dtype=t.dtype, device=device)

        return tree_map_with_path(block, self.whole)

    def shard_params(self, params):
        return shd.shard_tree(params, self.param_specs, self.mesh)

    def check_whole(self, whole) -> None:
        """Raise unless a state of whole shapes ``whole`` lies as the
        steps' plan reads it: its KV cache that of the state the steps
        were made for (no KV cache: any)."""
        if "kv" not in whole:
            return
        got = tuple(whole["kv"].k.shape)
        want = None if self.whole is None else tuple(self.whole["kv"].k.shape)
        if got != want:
            raise ValueError(
                f"a decode state whose KV cache is {got} over the mesh: the "
                f"steps were made for {want} (make_serve_step's batch= and "
                f"max_len=; the cache's layout over the mesh follows them)")

    def check_state(self, state) -> None:
        """Raise unless ``state``'s KV cache is this rank's block of the
        one the steps were made for."""
        if "kv" not in state:
            return
        if self.whole is None:
            self.check_whole(state)  # raises: made without batch, max_len
        spec = dict(tree_items(self.state_specs))["kv/k"]
        want = shd.local_shape(tuple(self.whole["kv"].k.shape), spec,
                               self.mesh)
        if tuple(state["kv"].k.shape) != want:
            raise ValueError(
                f"this rank's KV cache is {tuple(state['kv'].k.shape)}: the "
                f"steps read it as {want}, this rank's block of "
                f"{tuple(self.whole['kv'].k.shape)}")


def _layout(cfg: ModelConfig, mesh, whole_state, *, quantized: bool,
            paged: bool = False) -> _Layout:
    """The layout of ``cfg``'s params (``quantized``: the
    ``quantize_params`` tree, its specs by ``quantize_axes``) and of
    ``whole_state`` (or None) over ``mesh``."""
    axes, shapes = models.axes(cfg), models.init(cfg, device="meta")
    if quantized:
        from repro_torch.quant.prequant import quantize_axes, quantize_params

        axes, shapes = quantize_axes(axes), quantize_params(shapes)
    specs = shd.param_specs(axes, shapes, mesh)
    sspecs = None if whole_state is None else shd.decode_state_specs(
        whole_state, cfg, mesh, paged=paged)
    return _Layout(mesh, specs, fsdp.ShardPlan(
        mesh, specs, kv=None if sspecs is None else _kv_spec(sspecs,
                                                             whole_state)),
        fsdp.stacked_keys(axes), sspecs, whole_state)


def _kv_spec(specs, state):
    """The spec of ``state``'s stacked K leaf with an entry for each of its
    dims (the layers read its lanes or blocks at -4 and its sequence at
    -3), or None: no KV cache."""
    if "kv" not in state:
        return None
    spec, nd = specs["kv"].k, state["kv"].k.dim()
    return shd.P(*spec, *(None,) * (nd - len(spec)))


def _sharded(lay: _Layout, fn, *, lanes=(), gather: bool = False,
             whole: bool = False, state_of: bool = False):
    """``fn`` as a step over the mesh: under the mesh and the plan, in
    ``no_grad``, the leaves outside the stacked subtrees gathered once a
    call. The inputs at positions ``lanes`` (after params and state) are
    cut to this rank's lanes over the DP axes where the DP extent divides
    them (``batch_specs``); with ``gather`` the output's lanes are then
    all-gathered back, so every rank returns the whole. The plan's
    ``rows_whole`` says whether the step's rows are every rank's: ``whole``
    (a chunk, an admission), or lanes left uncut. ``state_of``: first
    check that the state is this rank's block of the layout's
    (:meth:`_Layout.check_state`)."""
    mesh = lay.mesh
    entry, size, _ = cd.data_parallel(mesh)

    def step(params, state, *inputs):
        if state_of:
            lay.check_state(state)
        inputs, split = list(inputs), False
        for i in lanes:
            t = inputs[i]
            if size > 1 and t.shape[0] % size == 0:
                inputs[i] = shd.shard_leaf(t, shd.P(entry), mesh)
                split = True
        plan = lay.plan.with_rows_whole(
            size > 1 and (whole or (bool(lanes) and not split)))
        with torch.no_grad(), use_context(mesh=mesh, shard=plan):
            out = fn(plan.tops(params, lay.stacked), state, *inputs)
            if split and gather:
                out = shd.gather_leaf(out, shd.P(entry), mesh)
        return out

    return step


def _captured(fn, device, mesh):
    """The step a CUDA graph holds per bucket; over a mesh with an axis
    above 1 eager (a graph cannot capture a ``gloo`` collective)."""
    eager = mesh is not None and any(n > 1 for n in mesh.shape)
    return CapturedStep(fn, device, capture=not eager)


def _slot_admit(params, state, prompt, slot, true_len, *, cfg, prompt_pad,
                sub: _Layout | None = None):
    """Prefill ``prompt`` (1, prompt_pad; right-padded) into a fresh
    one-row state and copy its KV into lane ``slot`` (a 0-d int tensor)
    of the per-slot contiguous cache, in place. Returns the request's
    first-token logits (Vp,).

    Over a mesh (``sub``: the one-row state's layout) the one-row state is
    this rank's block of it (``decode_state_specs``: its kv heads or
    head_dim over 'model', else its sequence over 'model' where that
    divides it; its sequence over DP where that divides it), the prefill
    runs under the plan naming that layout, a split sequence is
    all-gathered, and the copy writes what this rank holds of the lane
    cache: the lane where the lanes are split over DP (the others write
    the lane's old bytes back), its block of the positions where the
    sequence is split (over DP or 'model')."""
    if sub is None:
        sub_state = models.init_decode_state(cfg, 1, prompt_pad,
                                             device=prompt.device)
        logits, sub_state = models.prefill(params, {"tokens": prompt}, cfg,
                                           sub_state, last_pos=true_len - 1)
    else:
        plan = current_context().shard
        sub_state = sub.init_state(prompt.device)
        with use_context(shard=plan.with_kv(sub.plan.kv)):
            logits, sub_state = models.prefill(
                params, {"tokens": prompt}, cfg, sub_state,
                last_pos=true_len - 1)
    kv, skv = state["kv"], sub_state["kv"]
    lane = slot.reshape(1).long()
    srcs = (skv.k, skv.v)
    if sub is None:
        for dst, src in zip((kv.k, kv.v), srcs):
            dst[:, :, :prompt_pad].index_copy_(1, lane, src)
    else:
        mesh = sub.mesh
        over = lambda spec, dim: (spec[dim] if cd.axes_extent(
            mesh, spec[dim]) > 1 else None)
        if over(sub.plan.kv, -3) is not None:  # the prompt's K/V whole
            srcs = [cd.all_gather_over(t, mesh, over(sub.plan.kv, -3), 2)
                    for t in srcs]
        lanes, seq = over(plan.kv, -4), over(plan.kv, -3)
        at, own, lo, m = lane, None, 0, prompt_pad
        if lanes is not None:  # lanes over DP: the lane's rank writes it
            n = kv.k.shape[1]
            at = lane - cd.entry_index(mesh, lanes) * n
            own = (at >= 0) & (at < n)
            at = at.clamp(0, n - 1)
        if seq is not None:  # the sequence over DP or 'model': its block
            n = kv.k.shape[2]
            lo = cd.entry_index(mesh, seq) * n
            m = max(0, min(n, prompt_pad - lo))
        for dst, src in zip((kv.k, kv.v), srcs):
            src = src[:, :, lo:lo + m]
            if own is not None:  # the others write the lane's bytes back
                src = torch.where(own, src, dst[:, :, :m].index_select(1, at))
            dst[:, :, :m].index_copy_(1, at, src)
    kv.length.index_copy_(0, lane, true_len.reshape(1).to(kv.length.dtype))
    return logits[0]


@dataclasses.dataclass
class EngineArtifacts:
    """Steps of the contiguous continuous-batching engine.

    ``decode_fn(params, state, tokens, active)``: one masked decode tick
    for all ``num_slots`` lanes; ``admit_fn(params, state, prompt, slot,
    true_len)``: a one-request prefill whose KV lands in lane ``slot``.
    ``init_state(device)``: the engine's state (over a mesh, this rank's
    blocks of it; None without ``num_slots``); ``layout``: its layout over
    the mesh (None without one).
    """

    decode_fn: Callable
    admit_fn: Callable
    decode_raw: Callable
    admit_raw: Callable
    init_state: Callable
    layout: _Layout | None = None


def _engine_state(cfg, num_slots, max_len, mesh, **kw):
    """The engine state's allocator: ``init_decode_state`` of
    ``num_slots`` lanes (None: not given, which a mesh needs)."""
    if num_slots is None:
        if mesh is not None:
            raise ValueError("an engine step over a mesh needs num_slots")
        return None
    return lambda device: models.init_decode_state(
        cfg, num_slots, max_len, per_slot=True, device=device, **kw)


def make_engine_step(cfg: ModelConfig, *, max_len: int, prompt_pad: int,
                     device, num_slots: int | None = None, mesh=None,
                     quantized: bool = False) -> EngineArtifacts:
    """Both steps see one shape each: the tick (num_slots, 1) tokens against
    the (num_slots, max_len) per-slot cache, an admission a (1,
    prompt_pad) prompt; so each is one graph, and steady-state traffic
    issues one fixed GEMM-signature set.

    Over a ``mesh`` (the KV-cache families, dense and moe)
    the steps run sharded (:func:`_sharded`): the params this rank's blocks
    (``layout.shard_params``), the state too (``decode_state_specs``:
    the lanes over DP where its extent divides them, else the sequence,
    kv heads or head_dim over 'model'), the tick's tokens this rank's
    lanes and its logits gathered whole. Eager where an axis is above 1;
    on a 1 x 1 mesh captured."""
    _check_engine_family(cfg, "slot engine")
    if not 0 < prompt_pad < max_len:
        raise ValueError(
            f"need 0 < prompt_pad ({prompt_pad}) < max_len ({max_len})")
    state_fn = _engine_state(cfg, num_slots, max_len, mesh)
    lay = sub = None
    if mesh is not None:
        lay = _layout(cfg, mesh, state_fn("meta"), quantized=quantized)
        sub = _layout(cfg, mesh, models.init_decode_state(
            cfg, 1, prompt_pad, device="meta"), quantized=quantized)
        state_fn = lay.init_state

    def decode(params, state, tokens, active):
        return models.decode_step(params, tokens, cfg, state,
                                  active=active)[0]

    def admit(params, state, prompt, slot, true_len):
        return _slot_admit(params, state, prompt, slot, true_len, cfg=cfg,
                           prompt_pad=prompt_pad, sub=sub)

    if lay is not None:
        decode = _sharded(lay, decode, lanes=(0,), gather=True)
        admit = _sharded(lay, admit, whole=True)
    return EngineArtifacts(decode_fn=_captured(decode, device, mesh),
                           admit_fn=_captured(admit, device, mesh),
                           decode_raw=decode, admit_raw=admit,
                           init_state=state_fn, layout=lay)


@dataclasses.dataclass
class PagedEngineArtifacts:
    """Steps of the paged engine: ``decode_fn(params, state, tokens,
    active)``, one masked tick against the block pool; ``prefill_fn(params,
    state, chunk, slot, start, true_len, blocks)``, one chunked-prefill
    step, the chunk padded to one of ``chunk_buckets`` (one graph each).
    ``init_state(device)`` and ``layout`` as in :class:`EngineArtifacts`."""

    decode_fn: Callable
    prefill_fn: Callable
    decode_raw: Callable
    prefill_raw: Callable
    chunk_buckets: tuple[int, ...]
    max_blocks: int
    init_state: Callable
    layout: _Layout | None = None


def make_paged_engine_step(cfg: ModelConfig, *, max_len: int,
                           kv_block_size: int, num_kv_blocks: int,
                           chunk_buckets: tuple[int, ...], device,
                           num_slots: int | None = None, kv_dtype=None,
                           mesh=None,
                           quantized: bool = False) -> PagedEngineArtifacts:
    """Step factory for the paged (block-table) engine: the cache is a pool
    of ``num_kv_blocks`` x ``kv_block_size`` tokens (block 0 reserved), and
    admission prefill is chunked through the block table. ``kv_dtype``
    "int8" stores the pool in int8 with its scales; one factory serves
    both pool formats.

    Over a ``mesh`` as :func:`make_engine_step`, the pool by
    ``decode_state_specs(paged=True)``: its blocks over DP where the DP
    extent divides ``num_kv_blocks``, kv heads (else head_dim) over
    'model'; the table and lengths whole on every rank. A tick's lanes are
    cut over DP where the extent divides ``num_slots`` (its logits
    gathered whole); a chunk (one request) runs on every rank."""
    _check_engine_family(cfg, "paged engine")
    if kv_block_size < 1:
        raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
    if num_kv_blocks < 2:
        raise ValueError(
            f"num_kv_blocks must be >= 2 (block 0 is the reserved null "
            f"block), got {num_kv_blocks}")
    buckets = tuple(sorted({int(b) for b in chunk_buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bad chunk_buckets {chunk_buckets!r}")
    if buckets[-1] >= max_len:
        raise ValueError(
            f"largest chunk bucket ({buckets[-1]}) must be < max_len "
            f"({max_len})")
    state_fn = _engine_state(cfg, num_slots, max_len, mesh,
                             kv_block_size=kv_block_size,
                             num_kv_blocks=num_kv_blocks, kv_dtype=kv_dtype)
    lay = None
    if mesh is not None:
        lay = _layout(cfg, mesh, state_fn("meta"), quantized=quantized,
                      paged=True)
        state_fn = lay.init_state

    def decode(params, state, tokens, active):
        return models.decode_step(params, tokens, cfg, state,
                                  active=active)[0]

    def prefill_chunk(params, state, chunk, slot, start, true_len, blocks):
        return models.prefill_chunk(params, chunk, cfg, state, slot=slot,
                                    start=start, true_len=true_len,
                                    blocks=blocks)[0][0]

    if lay is not None:
        decode = _sharded(lay, decode, lanes=(0,), gather=True)
        prefill_chunk = _sharded(lay, prefill_chunk, whole=True)
    return PagedEngineArtifacts(
        decode_fn=_captured(decode, device, mesh),
        prefill_fn=_captured(prefill_chunk, device, mesh),
        decode_raw=decode, prefill_raw=prefill_chunk,
        chunk_buckets=buckets, max_blocks=-(-max_len // kv_block_size),
        init_state=state_fn, layout=lay)


@dataclasses.dataclass
class SpecArtifacts:
    """Steps of speculative decoding over the paged engine, each captured.

    ``verify_fn(params, state, tokens, active)``: one verify pass of the
    target over (num_slots, spec_k + 1) tokens (per lane, the last
    committed token and the draft's k proposals) into the paged state;
    logits at every fed position. ``draft_admit_fn(dparams, dstate,
    prompt, slot, true_len)``: a one-shot prompt prefill into the draft's
    per-slot contiguous cache. ``propose_fn(dparams, dstate, catch_tok,
    catch_active, start_tok, active)``: one graph that runs a masked
    catch-up decode (re-feeding the token a fully accepted round left
    behind) and then k greedy draft decodes chained by in-graph argmax over
    the true vocab; returns the (num_slots, k) proposals and updates the
    draft state in place. A speculative round is two replays, whatever k.
    All three see one shape each, so the engine's plan warm-up solves
    their GEMM signatures before serving. ``init_draft_state(device)``:
    the draft's state; ``draft_layout``: its layout over the mesh.
    """

    verify_fn: Callable
    draft_admit_fn: Callable
    propose_fn: Callable
    verify_raw: Callable
    draft_admit_raw: Callable
    propose_raw: Callable
    spec_k: int
    init_draft_state: Callable
    draft_layout: _Layout | None = None


def make_spec_step(cfg: ModelConfig, draft_cfg: ModelConfig, *,
                   max_len: int, prompt_pad: int, spec_k: int, device,
                   num_slots: int | None = None, mesh=None,
                   target: PagedEngineArtifacts | None = None,
                   draft_quantized: bool = False) -> SpecArtifacts:
    """Step factory for speculative decoding: the target's verify pass on
    the paged engine's state, and the draft's admit and propose on its own
    per-slot contiguous state (``init_decode_state(draft_cfg, num_slots,
    max_len, per_slot=True)``).

    Over a ``mesh`` the verify pass runs under the target's layout
    (``target``, the paged engine's artifacts), its lanes cut over DP and
    its logits gathered whole; the draft's steps under the draft's own
    layout (its contiguous state by ``decode_state_specs``), propose's
    tokens cut by lanes and its proposals gathered whole."""
    _check_engine_family(cfg, "speculative verify")
    _check_engine_family(draft_cfg, "draft model")
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch ({draft_cfg.vocab_size} vs "
            f"{cfg.vocab_size}) — proposals must share the token space")
    if not 0 < prompt_pad < max_len:
        raise ValueError(
            f"need 0 < prompt_pad ({prompt_pad}) < max_len ({max_len})")
    state_fn = _engine_state(draft_cfg, num_slots, max_len, mesh)
    lay = sub = None
    if mesh is not None:
        if target is None or target.layout is None:
            raise ValueError("over a mesh the verify pass needs the paged "
                             "engine's artifacts on it (target=)")
        lay = _layout(draft_cfg, mesh, state_fn("meta"),
                      quantized=draft_quantized)
        sub = _layout(draft_cfg, mesh, models.init_decode_state(
            draft_cfg, 1, prompt_pad, device="meta"),
            quantized=draft_quantized)
        state_fn = lay.init_state

    def verify(params, state, tokens, active):
        return models.verify_step(params, tokens, cfg, state,
                                  active=active)[0]

    def draft_admit(dparams, dstate, prompt, slot, true_len):
        return _slot_admit(dparams, dstate, prompt, slot, true_len,
                           cfg=draft_cfg, prompt_pad=prompt_pad, sub=sub)

    def propose(dparams, dstate, catch_tok, catch_active, start_tok, active):
        models.decode_step(dparams, catch_tok, draft_cfg, dstate,
                           active=catch_active)
        tok, proposals = start_tok, []
        for _ in range(spec_k):
            logits, _ = models.decode_step(dparams, tok, draft_cfg, dstate,
                                           active=active)
            tok = logits[:, :draft_cfg.vocab_size].argmax(-1)[:, None]
            proposals.append(tok[:, 0])
        return torch.stack(proposals, dim=1)

    if lay is not None:
        verify = _sharded(target.layout, verify, lanes=(0,), gather=True)
        draft_admit = _sharded(lay, draft_admit, whole=True)
        propose = _sharded(lay, propose, lanes=(0, 2), gather=True)
    return SpecArtifacts(
        verify_fn=_captured(verify, device, mesh),
        draft_admit_fn=_captured(draft_admit, device, mesh),
        propose_fn=_captured(propose, device, mesh),
        verify_raw=verify, draft_admit_raw=draft_admit, propose_raw=propose,
        spec_k=spec_k, init_draft_state=state_fn, draft_layout=lay)


__all__ = ["ServeArtifacts", "EngineArtifacts", "PagedEngineArtifacts",
           "SpecArtifacts", "make_serve_step", "make_engine_step",
           "make_paged_engine_step", "make_spec_step", "param_blocks",
           "prefill_input_shapes"]
