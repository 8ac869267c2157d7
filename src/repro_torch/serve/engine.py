"""Continuous-batching serving engine: fixed slot lanes, streaming requests
(port of ``repro.serve.engine``).

The step loop decouples request lifecycle (host-side scheduler) from the
step functions (device-side, fixed shapes, each a captured CUDA graph per
shape bucket on the card: ``train.servestep``):

* every tick runs ONE masked decode step for all ``num_slots`` lanes —
  vacant lanes are fed the pad token and excluded from sampling, and their
  cache position does not advance;
* admissions interleave between ticks. On the contiguous layout a
  single-request prefill (prompt right-padded to ``prompt_pad``) writes the
  slot's cache region in one shot. On the **paged** layout
  (``kv_block_size``) admission binds a lane and allocates KV blocks; the
  prompt then prefills chunk by chunk, interleaved with decode;
* eviction on stop-id / max-new-tokens frees the lane (and, paged, returns
  the request's blocks to the pool) for the queue head;
* admission order is a pluggable policy (``sched_policy``: fifo /
  priority / edf / prefix); preemptive policies evict and requeue strictly
  lower-ranked decodes under lane/block pressure. A per-tick **prefill
  budget** (``ttft_target_ms``) adapts how many chunked-prefill calls run
  per tick from observed TTFT;
* with the **prefix cache** (paged only), admission maps any cached prompt
  prefix's blocks straight into the slot's block table.

Slot count, chunk buckets, max_len and model dims are fixed at engine
build, so every tick issues one GEMM-signature set. ``plan_warmup`` solves
it by running the raw steps on the meta device, then ``run`` asserts zero
lazy plan solves (``PlanCache.expect_steady_state``). The decode state is
allocated once: the captured graphs hold its addresses, so ``reset``
zeroes it in place.

Sampling is host-side and per-request: greedy at ``temperature=0``, else
temperature + top-p from a per-request seeded stream.

With ``kv_quantize="int8"`` (paged only) the pool stores int8 blocks with
per-block, per-kv-head scales: about half the bytes a block, so an
equal-byte budget holds about twice the blocks (``quant.kvcache``).

With a draft model (``spec_draft_cfg``; paged, greedy and non-preemptive
only) every decode tick is a speculative round (``serve.spec``): the draft
proposes k tokens a lane in one captured step, the target verifies the
k + 1 positions in another, and the host commits each lane's accepted
prefix plus one bonus token, then rewinds both models' device lengths in
place (the captured graphs hold their addresses). Every committed token is
the target's own argmax, so the output equals non-speculative decode.

Over a ``mesh`` (``ServeEngine(cfg, params, mesh=...)``, the dense and
moe families) every step runs sharded (``train.servestep``): the params
and the state are this rank's blocks, tensor-parallel over 'model', the
MoE expert tables over 'data' (expert parallelism), the lanes and a pool's
blocks over DP where its extent divides them, the logits whole on every
rank. The params may be passed whole (the engine keeps its blocks) or as
this rank's blocks already (``blocks=True``: ``servestep.param_blocks``,
as a launcher that builds the model one rank at a time makes them). Every
rank runs the whole host schedule: the scheduler, the budget controller
and sampling (the same seeds) read the same logits and
the same clock, rank 0's reading broadcast over the mesh at every reading
(counted under the ``clock`` kind, apart from the steps' bytes). Each
step's collective bytes (in all and by kind) and host seconds are kept by
phase tag (``step_bytes``, ``step_kinds``, ``step_s``).

Observability (``repro_torch.obs``), off unless a tracer is passed: the
tracer records phase spans (``expire``, ``bind``, ``prefill-chunk``,
``admit``, ``decode``, ``sample``, ``spec-draft``, ``spec-verify``, and the
prefix cache's ``reclaim``) and request events; on a CUDA device each span
of a device phase also records a CUDA event pair, resolved at a snapshot
or the end of the run (``obs.trace``). The attribution ledger profiles the
GEMM signatures of each step during ``plan_warmup`` and counts step calls
by phase (``dispatches``) on the hot path; a traced run ends with the
metrics' ``timing`` and ``attribution`` sections, and the registry
mirrors the subsystems' counters every ``metrics_interval_ticks`` ticks
and at the end of the run.
"""
from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context
from repro_torch.layers.attention import PagedKVCache, reset_paged_kv_cache
from repro_torch.obs.attrib import AttributionLedger
from repro_torch.obs.registry import Registry, prom_name
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.quant.kvcache import KVCacheDtype, kv_block_bytes
from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.policy import BudgetController, SchedPolicy, get_policy
from repro_torch.serve.prefixcache import PrefixCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve import spec as spec_lib
from repro_torch.train.servestep import (make_engine_step,
                                         make_paged_engine_step,
                                         make_spec_step)


def chunk_buckets(chunk: int) -> tuple[int, ...]:
    """Bucket lengths chunked prefill pads to: {chunk/4, chunk/2, chunk}.

    Full chunks use the largest bucket; a prompt's tail rounds up to the
    smallest covering bucket — so prefill issues at most 3 distinct GEMM
    signatures (and graphs) instead of one per prompt length.
    """
    return tuple(sorted({max(1, chunk // 4), max(1, chunk // 2), chunk}))


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        num_slots: int,
        max_len: int,
        prompt_pad: int,
        pad_id: int = 0,
        kv_block_size: int | None = None,
        num_kv_blocks: int | None = None,
        kv_quantize: str | KVCacheDtype | None = None,
        prefill_chunk: int | None = None,
        prefix_cache: bool = False,
        prefix_cache_blocks: int | None = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        sched_policy: str | SchedPolicy | None = None,
        ttft_target_ms: float | None = None,
        max_prefill_chunks: int = 4,
        clock=None,
        spec_draft_cfg: ModelConfig | None = None,
        spec_draft_params=None,
        spec_k: int = 4,
        spec_draft_quant: str | None = None,
        tracer=None,
        registry: Registry | None = None,
        metrics_interval_ticks: int | None = None,
        attrib_tol: float = 0.25,
        mesh=None,
        blocks: bool = False,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.device = next(t for _, t in interop.tree_items(params)).device
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_pad = prompt_pad
        self.pad_id = pad_id
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.sched_policy = get_policy(sched_policy)
        self.ttft_target_ms = ttft_target_ms
        self.max_prefill_chunks = max_prefill_chunks
        # injectable clock (policy.SimClock in tests): TTFT, deadlines and
        # burst arrivals become deterministic functions of the event
        # sequence
        self._now = clock if clock is not None else time.perf_counter
        # over a mesh: rank 0's reading on every rank, and the bytes of
        # those broadcasts; each step's collective bytes and host seconds
        self.clock_bytes = cd.CollectiveCounter()
        if mesh is not None and mesh.size > 1:
            self._now = self._mesh_clock(self._now)
        self.step_bytes: dict[str, list[int]] = {}
        self.step_kinds: dict[str, list[dict[str, int]]] = {}
        self.step_s: dict[str, list[float]] = {}
        # with token_log a list: (request id, token index, token, top-2
        # margin, top logit) of every committed token, and first_logits
        # each request's first-token logits row (a record's, off by
        # default)
        self.token_log: list | None = None
        self.first_logits: dict[int, np.ndarray] = {}
        # observability: the tracer keeps its own clock and never reads
        # self._now (under SimClock a reading advances time, so tracing on
        # or off must not change the engine's readings); NULL_TRACER makes
        # every hook a no-op
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.tracer.time_device(self.device)
        self.registry = registry if registry is not None else Registry()
        self.metrics_interval_ticks = metrics_interval_ticks
        # the balance auditor: step profiles captured by plan_warmup, step
        # calls counted on the hot path (a plain int add), joined with the
        # traced phase seconds at the end of a traced run
        self.attrib = AttributionLedger(tol=attrib_tol)
        self.paged = bool(kv_block_size)
        self.kv_dtype = KVCacheDtype.parse(kv_quantize)
        if self.kv_dtype.quantized and not self.paged:
            raise ValueError(
                "KV quantization stores per-block scales alongside the "
                "block pool — it needs the paged engine (kv_block_size)")
        self.spec = spec_draft_cfg is not None
        self.spec_k = int(spec_k) if self.spec else 0
        self.spec_draft_cfg = spec_draft_cfg
        self.spec_draft_params = spec_draft_params
        self.spec_draft_quant = spec_draft_quant
        if self.spec:
            if spec_draft_params is None:
                raise ValueError(
                    "speculative decoding needs draft params "
                    "(spec_draft_params) alongside spec_draft_cfg")
            if not self.paged:
                raise ValueError(
                    "speculative decoding rewinds per-slot lengths over "
                    "budget-allocated blocks — it needs the paged engine "
                    "(kv_block_size)")
            if temperature and temperature > 0.0:
                raise ValueError(
                    f"speculative decoding verifies greedily; engine "
                    f"temperature={temperature} is incompatible (submit-"
                    f"time validation rejects per-request sampling too)")
            if self.sched_policy.preemptive:
                raise ValueError(
                    f"policy {self.sched_policy.name!r} preempts mid-"
                    f"decode; speculative lanes don't support preemption "
                    f"yet — use a non-preemptive policy (fifo/prefix)")
            if spec_draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size={spec_draft_cfg.vocab_size} != "
                    f"target vocab_size={cfg.vocab_size} — proposals must "
                    f"share the token space")
        if prefix_cache and not self.paged:
            raise ValueError(
                "the prefix cache shares KV at block granularity — it "
                "needs the paged engine (kv_block_size)")
        if self.sched_policy.preemptive and not self.paged:
            raise ValueError(
                f"policy {self.sched_policy.name!r} preempts via block "
                f"refcounts — it needs the paged engine (kv_block_size)")
        self.prefix_cache_enabled = bool(prefix_cache)
        self.prefix_cache_blocks = prefix_cache_blocks
        self._quantized = quantized = interop.is_quantized(params)
        if self.paged:
            self.kv_block_size = int(kv_block_size)
            # default pool: full contiguous capacity (+ the null block)
            full = -(-num_slots * max_len // self.kv_block_size) + 1
            self.num_kv_blocks = int(num_kv_blocks or full)
            self.prefill_chunk = int(prefill_chunk or prompt_pad)
            self.chunk_buckets = chunk_buckets(self.prefill_chunk)
            self.art = self._paged_art(self.device, mesh)
        else:
            self.kv_block_size = None
            self.num_kv_blocks = None
            self.prefill_chunk = None
            self.chunk_buckets = None
            self.art = make_engine_step(cfg, num_slots=num_slots,
                                        max_len=max_len,
                                        prompt_pad=prompt_pad,
                                        device=self.device, mesh=mesh,
                                        quantized=quantized)
        self.spec_art = (self._spec_art(self.device, mesh, self.art)
                         if self.spec else None)
        # over a mesh the params are this rank's blocks
        self.params = params
        if self.art.layout is not None and not blocks:
            self.params = self.art.layout.shard_params(params)
            if self.spec:
                self.spec_draft_params = \
                    self.spec_art.draft_layout.shard_params(
                        spec_draft_params)
        self.state = None
        self.draft_state = None
        self._warmed = False
        self.reset()

    @property
    def dispatches(self) -> dict[str, int]:
        """Step calls by phase tag ("decode", "admit" (the draft's, under
        speculation), "prefill-chunk@<bucket>", "spec-draft",
        "spec-verify") since the last reset: the attribution ledger's
        counts, which with the dispatch rule give a run's kernel
        launches."""
        return self.attrib.dispatches

    def _paged_art(self, device, mesh):
        return make_paged_engine_step(
            self.cfg, num_slots=self.num_slots, max_len=self.max_len,
            kv_block_size=self.kv_block_size,
            num_kv_blocks=self.num_kv_blocks,
            chunk_buckets=self.chunk_buckets, device=device,
            kv_dtype=self.kv_dtype, mesh=mesh,
            quantized=self._quantized)

    def _spec_art(self, device, mesh, target):
        return make_spec_step(
            self.cfg, self.spec_draft_cfg, num_slots=self.num_slots,
            max_len=self.max_len, prompt_pad=self.prompt_pad,
            spec_k=self.spec_k, device=device, mesh=mesh, target=target,
            draft_quantized=interop.is_quantized(self.spec_draft_params))

    def _mesh_clock(self, clock):
        """``clock`` read on rank 0 and broadcast over the mesh, axis by
        axis (each from its index 0): two ranks' clocks differ, and every
        decision of the schedule (arrivals, TTFT, deadlines, the budget)
        reads the engine's clock."""
        mesh = self.mesh
        dev = mesh.device if mesh.backend == "nccl" else "cpu"

        def now() -> float:
            t = torch.tensor([clock()], dtype=torch.float64, device=dev)
            with self.clock_bytes:
                for axis in mesh.axis_names:
                    cd.broadcast(t, mesh, axis, 0, kind="clock")
            return float(t.item())

        return now

    def _call(self, tag: str, fn, *args):
        """One step call; over a mesh its collective bytes and host seconds
        (the card synchronized) kept under ``tag``."""
        if self.mesh is None:
            return fn(*args)
        t0 = time.perf_counter()
        with cd.CollectiveCounter() as counter:
            out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_s.setdefault(tag, []).append(time.perf_counter() - t0)
        self.step_bytes.setdefault(tag, []).append(counter.total)
        self.step_kinds.setdefault(tag, []).append(counter.by_kind())
        return out

    @property
    def pool_bytes(self) -> int:
        """The bytes of this rank's KV cache or pool (over a mesh its
        blocks): K, V and an int8 pool's scales; the table, the lengths and
        the draft's cache not included."""
        kv = self.state["kv"]
        return sum(t.numel() * t.element_size()
                   for t in (kv.k, kv.v, getattr(kv, "k_scale", None),
                             getattr(kv, "v_scale", None)) if t is not None)

    def _block_bytes(self, kv_dtype: KVCacheDtype) -> int:
        """Bytes of one pool block over the layers (``kv_block_bytes``)."""
        return kv_block_bytes(self.kv_block_size, self.cfg.n_kv_heads,
                              self.cfg.head_dim, kv_dtype,
                              n_layers=self.cfg.n_layers)

    def _new_state(self, device) -> dict:
        """The engine's state (over a mesh, this rank's blocks)."""
        return self.art.init_state(device)

    def _new_draft_state(self, device) -> dict:
        """The draft's per-slot contiguous cache (prompts admit in one
        padded shot, so it needs no pool)."""
        return self.spec_art.init_draft_state(device)

    def _rel_now(self) -> float:
        """Seconds on the engine clock since the last reset — the time
        base every stamp, deadline and ``arrival_s`` lives in."""
        return self._now() - self._t0

    # ------------------------------------------------------------ state
    def reset(self) -> None:
        """Fresh scheduler, metrics and a fresh state; the captured steps
        are kept (their graphs hold the state's addresses, so the state is
        reset in place, never reallocated, to what ``init_decode_state``
        makes)."""
        ctx = current_context()
        self.tracer.reset()
        self.attrib.reset_run()
        self.clock_bytes = cd.CollectiveCounter()
        self.step_bytes, self.step_kinds, self.step_s = {}, {}, {}
        self._t0 = self._now()
        if self.state is None:
            self.state = self._new_state(self.device)
            if self.spec:
                self.draft_state = self._new_draft_state(self.device)
        else:
            for state in (self.state, self.draft_state or {}):
                for leaf in state.values():
                    if isinstance(leaf, PagedKVCache):
                        reset_paged_kv_cache(leaf)
                    else:
                        for _, t in interop.tree_items(leaf):
                            t.zero_()
        pool = (BlockPool(self.num_kv_blocks, self.kv_block_size,
                          bytes_per_block=self._block_bytes(self.kv_dtype))
                if self.paged else None)
        cache = (PrefixCache(pool, max_cached_blocks=self.prefix_cache_blocks,
                             tracer=self.tracer)
                 if self.prefix_cache_enabled else None)
        self.sched = SlotScheduler(self.num_slots, max_len=self.max_len,
                                   pool=pool, prefix_cache=cache,
                                   policy=self.sched_policy, spec=self.spec,
                                   tracer=self.tracer)
        if self.spec:
            # per-lane draft bookkeeping: lag marks lanes whose draft KV is
            # one token behind the committed stream (a fully accepted
            # round's last proposal was never fed back); catch_tok is that
            # token, re-fed by the next propose step
            self._lag = np.zeros((self.num_slots,), bool)
            self._catch_tok = np.full((self.num_slots,), self.pad_id,
                                      np.int64)
            self.spec_stats = spec_lib.SpecStats(spec_k=self.spec_k)
        self.budget = BudgetController(
            None if self.ttft_target_ms is None
            else self.ttft_target_ms / 1e3,
            max_chunks=self.max_prefill_chunks)
        self._next_tok = np.full((self.num_slots,), self.pad_id, np.int64)
        engine_info = {
            "arch": self.cfg.name,
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "prompt_pad": self.prompt_pad,
            "hw": ctx.hw.name,
            "backend": self.device.type,
            "quant": ctx.quant_mode,
            "paged": self.paged,
            "temperature": self.temperature,
            "top_p": self.top_p,
            "sched_policy": self.sched_policy.name,
            "ttft_target_ms": self.ttft_target_ms,
        }
        if self.paged:
            engine_info.update(
                kv_block_size=self.kv_block_size,
                num_kv_blocks=self.num_kv_blocks,
                kv_dtype=self.kv_dtype.value,
                prefill_chunk=self.prefill_chunk,
                chunk_buckets=list(self.chunk_buckets),
                prefix_cache=self.prefix_cache_enabled,
                prefix_cache_blocks=self.prefix_cache_blocks)
        engine_info["spec"] = self.spec
        if self.mesh is not None:
            engine_info["mesh"] = self.mesh.describe()
        if self.spec:
            engine_info.update(
                spec_k=self.spec_k,
                spec_draft_arch=self.spec_draft_cfg.name,
                spec_draft_quant=self.spec_draft_quant)
        self.metrics = EngineMetrics(engine=engine_info)

    # ------------------------------------------------------------ warm-up
    def plan_warmup(self) -> dict[str, int]:
        """Pre-solve every GEMM signature the engine's steps issue by running
        the raw steps on the meta device (the engine-shaped counterpart of
        ``core.gemm.plan_model``): one chunked-prefill step per bucket (or
        the admit step) plus the decode tick, and under speculation the
        target's (num_slots, k + 1) verify pass and the draft's admit and
        propose steps (the draft's int8 signatures run under the target's
        context, so its unembed stays float). Marks the engine warm:
        later ``run`` calls assert steady state. The graphs are captured
        after this, at each bucket's first call. Over a mesh the steps are
        the sharded ones on an abstract copy of it (its collectives count
        and move nothing), at this rank's local shapes, as
        ``core.gemm.plan_model`` runs the static server's."""
        cache = current_context().plan_cache
        before = cache.stats.snapshot()
        meta = lambda shape: torch.empty(shape, dtype=torch.int64,
                                         device="meta")
        on_meta = lambda tree: interop.tree_map(
            lambda t: torch.empty_like(t, device="meta"), tree)
        params = on_meta(self.params)
        art, spec_art = self.art, self.spec_art
        if self.mesh is not None:
            abstract = self.mesh.as_abstract()
            if self.paged:
                art = self._paged_art("meta", abstract)
            else:
                art = make_engine_step(
                    self.cfg, num_slots=self.num_slots,
                    max_len=self.max_len, prompt_pad=self.prompt_pad,
                    device="meta", mesh=abstract, quantized=self._quantized)
            if self.spec:
                spec_art = self._spec_art("meta", abstract, art)
        state = art.init_state("meta")
        # each step runs under an attribution capture: the ledger records
        # which GEMM signatures one execution of the step consults, and how
        # often (the profile it joins with the traced phase seconds)
        capture = self.attrib.capture
        with cache.warmup():
            if self.paged:
                for bucket in self.chunk_buckets:
                    with capture(f"prefill-chunk@{bucket}"):
                        art.prefill_raw(
                            params, state, meta((1, bucket)), meta(()),
                            meta(()), meta(()), meta((art.max_blocks,)))
            else:
                with capture("admit"):
                    art.admit_raw(params, state, meta((1, self.prompt_pad)),
                                  meta(()), meta(()))
            toks, active = meta((self.num_slots, 1)), meta((self.num_slots,))
            with capture("decode"):
                art.decode_raw(params, state, toks, active)
            if self.spec:
                dparams = on_meta(self.spec_draft_params)
                dstate = spec_art.init_draft_state("meta")
                with capture("spec-verify"):
                    spec_art.verify_raw(
                        params, state, meta((self.num_slots, self.spec_k + 1)),
                        active)
                # the draft's admission runs inside the engine's "admit"
                # spans (speculation needs the paged engine, so the
                # contiguous admit tag is never live beside it)
                with capture("admit"):
                    spec_art.draft_admit_raw(
                        dparams, dstate, meta((1, self.prompt_pad)),
                        meta(()), meta(()))
                with capture("spec-draft"):
                    spec_art.propose_raw(dparams, dstate, toks, active, toks,
                                         active)
        self._warmed = True
        solved = cache.stats.warm_solves - before.warm_solves
        signatures = len(cache.warm_keys)
        return {"signatures": signatures, "solved": solved,
                "from_cache": signatures - solved}

    # ------------------------------------------------------------ intake
    def submit(self, request: Request, now_s: float | None = None) -> Request:
        if not self.paged and request.prompt_len > self.prompt_pad:
            raise ValueError(
                f"prompt_len={request.prompt_len} exceeds the engine's "
                f"prompt_pad={self.prompt_pad}")
        if self.spec and request.prompt_len > self.prompt_pad:
            raise ValueError(
                f"prompt_len={request.prompt_len} exceeds prompt_pad="
                f"{self.prompt_pad}: the speculative draft model admits "
                f"prompts in one padded shot even on the paged engine")
        return self.sched.submit(
            request, now_s if now_s is not None else self._rel_now())

    # ------------------------------------------------------------ sampling
    def _sample(self, logits_row: np.ndarray, st: RequestState) -> int:
        """Sample one token for ``st`` from its lane's logits (host-side;
        the padded vocab tail is never sampled). Greedy at temperature 0,
        else temperature + top-p nucleus sampling from the request's seeded
        stream."""
        req = st.request
        logits = np.asarray(logits_row[: self.cfg.vocab_size], np.float64)
        temp = (req.temperature if req.temperature is not None
                else self.temperature)
        if temp is None or temp <= 0.0:
            return int(np.argmax(logits))
        top_p = req.top_p if req.top_p is not None else self.top_p
        z = logits / temp
        z -= z.max()
        probs = np.exp(z)
        probs /= probs.sum()
        if top_p < 1.0:
            order = np.argsort(-probs, kind="stable")
            csum = np.cumsum(probs[order])
            # smallest prefix with mass >= top_p (the boundary token stays)
            cut = int(np.searchsorted(csum, top_p)) + 1
            keep = order[:cut]
            mask = np.zeros_like(probs)
            mask[keep] = probs[keep]
            probs = mask / mask.sum()
        if st.rng is None:
            st.rng = np.random.default_rng(
                req.seed if req.seed is not None
                else [self.seed, st.admission_index])
        return int(st.rng.choice(probs.shape[0], p=probs))

    # ------------------------------------------------------------ ticking
    def _log_token(self, st: RequestState, row: np.ndarray, tok: int) -> None:
        """Append a committed token to ``token_log`` (when it is a list)
        with the top-2 margin of the logits row that chose it."""
        if self.token_log is None:
            return
        row = np.asarray(row[: self.cfg.vocab_size], np.float64)
        top = np.partition(row, row.shape[0] - 2)[-2:]
        hi, lo = max(top), min(top)
        rid = st.request.request_id
        if not st.tokens and rid not in self.first_logits:
            self.first_logits[rid] = row.astype(np.float32)
        self.token_log.append((rid, len(st.tokens), int(tok), hi - lo, hi))

    def _finish(self, st: RequestState, reason: str, now: float) -> None:
        self.sched.evict(st.slot, reason, now)
        self.metrics.record_request(st)

    def _budget(self, st: RequestState) -> int:
        """Effective generation budget (``Request.budget``, shared with the
        scheduler's block-allocation sizing)."""
        return st.request.budget(self.max_len)

    def _first_token(self, st: RequestState, logits: np.ndarray,
                     now: float) -> None:
        """Record the first token falling out of a completed prefill (a
        resumed prefill lands here too; only a first token ever feeds the
        budget controller's TTFT loop)."""
        first_ever = st.first_token_s is None
        tok = self._sample(logits, st)
        self._log_token(st, logits, tok)
        st.append(tok, now, tick=self.sched.tick)
        if first_ever:
            self.budget.observe_ttft(now - st.request.submitted_s)
            self.tracer.request_event("first-token", st.request.request_id,
                                      slot=st.slot)
        self._next_tok[st.slot] = tok
        reason = ("length" if len(st.tokens) >= self._budget(st)
                  else st.should_stop())
        if reason:
            self._finish(st, reason, now)

    def _admit_all(self, now: float) -> int:
        """Contiguous path: drain the queue into free lanes; each admission
        prefills in one shot and yields the request's first token. Returns
        tokens produced."""
        n = 0
        while True:
            st = self.sched.admit_next(now)
            if st is None:
                return n
            n += 1
            req = st.request
            prompt = np.full((1, self.prompt_pad), self.pad_id, np.int64)
            prompt[0, : req.prompt_len] = req.prompt
            self.attrib.dispatch("admit")
            with self.tracer.phase("admit", slot=st.slot):
                logits = self._call("admit", self.art.admit_fn, self.params,
                                    self.state, prompt, st.slot,
                                    req.prompt_len)
                np_logits = logits.cpu().numpy()
            self._first_token(st, np_logits, self._rel_now())

    def _bind_admissions(self, now: float) -> None:
        """Paged path: bind queue heads to free lanes and allocate their KV
        blocks; the target's prompts prefill chunk by chunk over the next
        ticks. Under speculation each admission also prefills the draft's
        per-slot cache in one shot (the draft does not share the target's
        prefix cache: it always takes the whole prompt)."""
        while True:
            st = self.sched.admit_next(now)
            if st is None:
                return
            if self.spec:
                self._draft_admit(st)

    def _draft_admit(self, st: RequestState) -> None:
        """Prefill the draft for a newly admitted lane, overwriting what the
        lane's previous occupant left in the draft cache, and clear the
        lane's lag."""
        req = st.request
        prompt = np.full((1, self.prompt_pad), self.pad_id, np.int64)
        prompt[0, : req.prompt_len] = req.prompt
        self.attrib.dispatch("admit")
        with self.tracer.phase("admit", slot=st.slot, draft=True):
            self._call("admit", self.spec_art.draft_admit_fn,
                       self.spec_draft_params, self.draft_state, prompt,
                       st.slot, req.prompt_len)
        self._lag[st.slot] = False

    def _chunk_shape(self, remaining: int) -> tuple[int, int]:
        """(bucket_len, true_len) for the next prefill chunk."""
        if remaining >= self.prefill_chunk:
            return self.prefill_chunk, self.prefill_chunk
        for b in self.chunk_buckets:
            if b >= remaining:
                return b, remaining
        return self.prefill_chunk, remaining  # unreachable; buckets cover it

    def _prefill_tick(self, now: float) -> int:
        """Run ONE chunked-prefill step for the oldest mid-prefill lane.
        The final chunk yields the request's first token (or, resumed, the
        next token of the stream). Returns tokens produced (0 or 1)."""
        st = self.sched.prefill_head()
        if st is None:
            return 0
        # the prefill sequence is the admission snapshot: the bare prompt
        # for a fresh request, prompt + generated-so-far for a resume
        seq = (st.prefill_tokens if st.prefill_tokens is not None
               else st.request.prompt)
        start = st.prefill_done
        bucket, n = self._chunk_shape(st._target - start)
        chunk = np.full((1, bucket), self.pad_id, np.int64)
        chunk[0, :n] = seq[start: start + n]
        blocks = np.zeros((self.art.max_blocks,), np.int64)
        blocks[: len(st.blocks)] = st.blocks
        self.attrib.dispatch(f"prefill-chunk@{bucket}")
        with self.tracer.phase("prefill-chunk", slot=st.slot, n=n,
                               bucket=bucket):
            logits = self._call(f"prefill-chunk@{bucket}",
                                self.art.prefill_fn, self.params, self.state,
                                chunk, st.slot, start, n, blocks)
        self.sched.prefill_advance(st.slot, n)
        self.tracer.request_event("chunk", st.request.request_id,
                                  slot=st.slot, n=n, done=st.prefill_done)
        if st.prefilling:
            return 0
        self._first_token(st, logits.cpu().numpy(), self._rel_now())
        return 1

    def _spec_round(self, mask: np.ndarray) -> int:
        """One speculative round for the decode-ready lanes: the draft's
        k-step propose, one (num_slots, k + 1) target verify, then greedy
        acceptance per lane on the host (``serve.spec`` holds the math).

        Every committed token is the target's own argmax at its position,
        so the output equals non-speculative decode token for token. The
        rejected tail rewinds both models' per-slot lengths: read from the
        card, adjusted on the host and written back in place, since the
        verify, decode and prefill graphs hold the target's length tensor
        and the propose and admit graphs the draft's (blocks were
        allocated at budget: the allocator is untouched)."""
        k = self.spec_k
        tr = self.tracer
        self.attrib.dispatch("spec-draft")
        self.attrib.dispatch("spec-verify")
        t0 = time.perf_counter()
        m0 = tr.device_mark()
        start_toks = np.where(mask, self._next_tok, self.pad_id)
        catch_mask = mask & self._lag
        proposals = self._call(
            "spec-draft", self.spec_art.propose_fn, self.spec_draft_params,
            self.draft_state, self._catch_tok[:, None],
            catch_mask.astype(np.int64), start_toks[:, None],
            mask.astype(np.int64))
        np_props = proposals.cpu().numpy()                 # (num_slots, k)
        t1 = time.perf_counter()
        m1 = tr.device_mark()
        fed = np.concatenate(
            [start_toks[:, None],
             np.where(mask[:, None], np_props, self.pad_id)],
            axis=1)                                        # (num_slots, k+1)
        logits = self._call("spec-verify", self.spec_art.verify_fn,
                            self.params, self.state, fed,
                            mask.astype(np.int64))
        np_logits = logits.cpu().numpy()           # (num_slots, k+1, Vp)
        t2 = time.perf_counter()
        m2 = tr.device_mark()
        self.spec_stats.draft_s += t1 - t0
        self.spec_stats.verify_s += t2 - t1
        if tr.enabled:
            # externally timed spans with the same clock readings as
            # SpecStats: the summed spans reconcile with draft_s/verify_s
            tr.phase_span("spec-draft", t0, t1, marks=(m0, m1))
            tr.phase_span("spec-verify", t1, t2, marks=(m1, m2))
        now = self._rel_now()
        with tr.phase("sample", n=int(mask.sum())):
            produced = self._accept(mask, np_props, np_logits, now)
        return produced

    def _accept(self, mask: np.ndarray, np_props: np.ndarray,
                np_logits: np.ndarray, now: float) -> int:
        """A speculative round's host side: each lane's accepted prefix
        and bonus token committed, its lengths rewound. Returns tokens
        produced."""
        k = self.spec_k
        # post-verify lengths: every active lane advanced by k + 1; the
        # acceptance walk decides how far each rolls back
        tgt_len = self.state["kv"].length.cpu().numpy().copy()
        drf_len = self.draft_state["kv"].length.cpu().numpy().copy()
        produced = 0
        for slot in np.flatnonzero(mask).tolist():
            st = self.sched.slots[slot]
            self.sched.advance_written(slot, k + 1)
            greedy = spec_lib.greedy_rows(np_logits[slot],
                                          self.cfg.vocab_size)
            committed, n_accepted = spec_lib.accept_prefix(np_props[slot],
                                                           greedy)
            finished = False
            n_committed = 0
            for i, tok in enumerate(committed):
                self._log_token(st, np_logits[slot][i], tok)
                st.append(tok, now, tick=self.sched.tick)
                self._next_tok[slot] = tok
                n_committed += 1
                produced += 1
                reason = ("length" if len(st.tokens) >= self._budget(st)
                          else st.should_stop())
                if reason:
                    # committed[:n_accepted] are accepted proposals and
                    # committed[n_accepted] the bonus: a finish at index i
                    # used min(i + 1, n_accepted) proposals
                    n_accepted = min(n_accepted, i + 1)
                    self._finish(st, reason, now)
                    finished = True
                    break
            self.spec_stats.record_round(k, n_accepted, n_committed)
            if finished:
                continue
            # the target's KV covers every committed token but the newest
            rewind = spec_lib.verify_rewind(k, n_accepted)
            self.sched.rewind(slot, rewind)
            tgt_len[slot] -= rewind
            committed_len = st.request.prompt_len + len(st.tokens)
            drf_len[slot], lag = spec_lib.draft_sync(committed_len,
                                                     n_accepted, k)
            self._lag[slot] = lag
            if lag:
                self._catch_tok[slot] = st.tokens[-2]
        self.state["kv"].length.copy_(torch.from_numpy(tgt_len))
        self.draft_state["kv"].length.copy_(torch.from_numpy(drf_len))
        return produced

    def tick(self) -> int:
        """One engine tick: deadline sweep, admissions (plus, paged, up to
        ``budget.chunks_per_tick()`` prefill chunks), then one masked
        decode step (under speculation, one round) for the decode-ready
        lanes. Returns the number of tokens generated."""
        tr = self.tracer
        tr.set_tick(self.sched.tick)
        now = self._rel_now()
        with tr.phase("expire"):
            for st in self.sched.expire_deadlines(now):
                self.metrics.record_request(st)
        if self.paged:
            with tr.phase("bind"):
                self._bind_admissions(now)
            produced = 0
            # the budget controller's knob: how much of this tick goes to
            # prefill (TTFT) vs decode (throughput), over the same buckets
            for _ in range(self.budget.chunks_per_tick()):
                if self.sched.prefill_head() is None:
                    break
                produced += self._prefill_tick(now)
        else:
            produced = self._admit_all(now)
        mask = self.sched.decode_mask()
        ready = int(mask.sum())
        if ready and self.spec:
            produced += self._spec_round(mask)
        elif ready:
            toks = np.where(mask, self._next_tok, self.pad_id)
            self.attrib.dispatch("decode")
            with tr.phase("decode", n=ready):
                logits = self._call("decode", self.art.decode_fn,
                                    self.params, self.state, toks[:, None],
                                    mask.astype(np.int64))
                np_logits = logits.cpu().numpy()
            now = self._rel_now()
            with tr.phase("sample", n=ready):
                for slot in np.flatnonzero(mask).tolist():
                    st = self.sched.slots[slot]
                    tok = self._sample(np_logits[slot], st)
                    self._log_token(st, np_logits[slot], tok)
                    st.append(tok, now, tick=self.sched.tick)
                    self._next_tok[slot] = tok
                    produced += 1
                    reason = ("length" if len(st.tokens) >= self._budget(st)
                              else st.should_stop())
                    if reason:
                        self._finish(st, reason, now)
        if self.paged:
            self.metrics.record_block_pool(
                self.sched.pool, self.sched.live_tokens(),
                contiguous_tokens=self.num_slots * self.max_len)
        # occupancy counts lanes that decoded this tick (token-steps
        # computed); mid-prefill lanes are visible in the prefill metrics
        self.metrics.record_tick(ready, produced, self.sched.pending)
        self.sched.tick += 1
        if (self.metrics_interval_ticks
                and self.sched.tick % self.metrics_interval_ticks == 0):
            self._publish_registry()
            self.registry.snapshot(tick=self.sched.tick)
            if tr.enabled:
                self._emit_counters()
        return produced

    def _emit_counters(self) -> None:
        """Counter tracks at the snapshot cadence (traced runs only):
        engine progress, pool pressure, and the attributed device seconds
        by bound class (resolving the CUDA events recorded so far, one
        synchronize)."""
        tr = self.tracer
        m = self.metrics
        tr.counter("engine_progress", {
            "generated_tokens": m.generated_tokens,
            "queued": self.sched.pending,
        })
        if self.paged:
            tr.counter("block_pool", {
                "blocks_in_use": self.sched.pool.blocks_in_use,
                "free_blocks": self.sched.pool.free_blocks,
            })
        tr.counter("attrib_device_s", self.attrib.class_seconds(
            tr.device_durations(), cache=current_context().plan_cache))

    # ------------------------------------------------------------ driving
    def run(self, requests: Iterable[Request] = ()) -> EngineMetrics:
        """Run ``requests`` to completion and return the filled metrics.

        Arrival-aware: a request is submitted once the engine clock reaches
        its ``arrival_s``; one whose deadline passed while it waited to
        arrive is terminal-missed without ever queueing. After
        ``plan_warmup`` the loop runs under the zero-lazy-solve assertion.
        """
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.request_id))
        cache = current_context().plan_cache
        before = cache.stats.snapshot()
        t_start = self._rel_now()

        def step():
            now = self._rel_now()
            while pending and pending[0].arrival_s <= now:
                r = pending.pop(0)
                if r.deadline_s is not None and r.deadline_s <= now:
                    self.metrics.record_request(
                        self.sched.drop_expired(r, now))
                else:
                    self.sched.submit(r, now)
            self.tick()

        listener = None
        if self.tracer.enabled:
            # plan-solve events on the timeline: none fire in steady
            # state, so a "plan-lazy_solve" instant is the regression
            tr = self.tracer

            def listener(event, key):
                tr.instant(f"plan-{event}", key="|".join(map(str, key)))
            cache.add_listener(listener)
        try:
            if self._warmed:
                with cache.expect_steady_state("serve-engine loop"):
                    while pending or not self.sched.idle:
                        step()
            else:
                while pending or not self.sched.idle:
                    step()
        finally:
            if listener is not None:
                cache.remove_listener(listener)
        self.metrics.wall_s = self._rel_now() - t_start
        self.metrics.record_plan_cache(before, cache.stats.snapshot())
        counters = self.sched.counters()
        self.metrics.admissions = counters["admissions"]
        self.metrics.evictions = counters["evictions"]
        self.metrics.deferred_admissions = counters["deferred_admissions"]
        self.metrics.preemptions = counters["preemptions"]
        self.metrics.resumes = counters["resumes"]
        self.metrics.deadline_missed = counters["deadline_missed"]
        self.metrics.policy = counters["policy"]
        self.metrics.budget = self.budget.stats()
        if self.paged:
            self.metrics.record_kv_cache(
                kv_dtype=self.kv_dtype.value,
                bytes_per_block=self.sched.pool.bytes_per_block,
                num_blocks=self.num_kv_blocks,
                bf16_bytes_per_block=self._block_bytes(KVCacheDtype.BF16),
                scale_stats=self._scale_stats())
        if self.sched.prefix_cache is not None:
            self.metrics.record_prefix_cache(self.sched.prefix_cache)
        if self.spec:
            self.metrics.record_speculation(
                self.spec_stats, draft_arch=self.spec_draft_cfg.name,
                draft_quant=self.spec_draft_quant)
        self.metrics.slo_burn = self.metrics.slo_burn_summary(
            None if self.ttft_target_ms is None
            else self.ttft_target_ms / 1e3)
        if self.tracer.enabled:
            self.metrics.timing = self.tracer.phase_summary()
            for name, durs in self.tracer.phase_durations().items():
                h = self.registry.histogram(
                    f"repro_serve_phase_{prom_name(name)}_seconds",
                    "engine phase span duration (s)")
                for d in durs:
                    h.observe(d)
            # the balance auditor's join: the device phases' seconds (on
            # the card, their CUDA-event seconds) apportioned over the
            # GEMM signatures, each cached plan held to the model and its
            # solve-time snapshot. Reads cache.entries directly: the
            # steady-state counters are untouched
            self.metrics.attribution = self.attrib.summarize(
                self.tracer.device_durations(), cache=cache)
            self._publish_attrib(self.metrics.attribution)
        self._publish_registry()
        if self.metrics_interval_ticks:
            self.registry.snapshot(tick=self.sched.tick)
        return self.metrics

    def _publish_attrib(self, a: dict) -> None:
        """Mirror the attribution summary into ``repro_attrib_*`` gauges
        plus a measured-vs-modeled ratio histogram."""
        reg = self.registry
        reg.ingest("attrib", {
            "signatures": a["signatures"],
            "drifted": a["drifted_count"],
            "attributed_device_s": a["attributed_device_s"],
            "traced_device_s": a["traced_device_s"],
            "unattributed_device_s": a["unattributed_device_s"],
            "reconciliation_error": a["reconciliation_error"],
            "bound_s": a["bound_s"],
        })
        h = reg.histogram(
            "repro_attrib_measured_vs_modeled",
            "per-signature measured/modeled device seconds ratio",
            buckets=(0.25, 0.5, 0.9, 1.1, 2.0, 8.0, 64.0, 1024.0))
        for row in a["by_device_s"]:
            if row["measured_vs_modeled"] is not None:
                h.observe(row["measured_vs_modeled"])

    def _publish_registry(self) -> None:
        """Mirror the subsystem counters into the registry (gauges named
        ``repro_serve_*`` / ``repro_plan_cache_*``). The dicts the metrics
        JSON is built from are the source of truth; the registry re-homes
        them. The kv_cache section (whose scale gauges read the card) is
        filled at the end of a run only."""
        reg = self.registry
        m = self.metrics
        reg.ingest("serve", {
            "ticks": m.ticks,
            "generated_tokens": m.generated_tokens,
            "occupancy_sum": m.occupancy_sum,
            "queue_peak": m.queue_peak,
        })
        reg.ingest("serve_sched", self.sched.counters())
        reg.ingest("serve_budget", self.budget.stats())
        if m.kv_cache:
            reg.ingest("serve_kv", m.kv_cache)
        if self.spec:
            self.spec_stats.publish(reg)
        pcs = current_context().plan_cache.stats
        reg.ingest("plan_cache", {
            "hits": pcs.hits, "misses": pcs.misses,
            "warm_solves": pcs.warm_solves, "lazy_solves": pcs.lazy_solves,
        })

    def _scale_stats(self) -> dict[str, float] | None:
        """The dequant-error gauges of an int8 pool: a block's worst-case
        quantization error is scale/2, so the scales' mean and max bound
        the cache's drift. Blocks never written keep the initial scale of
        exactly 1.0 (a requantized block's absmax/127 never lands there)
        and are left out, unless no block was written."""
        if not self.kv_dtype.quantized:
            return None
        out = {}
        for name in ("k", "v"):
            s = getattr(self.state["kv"], f"{name}_scale")
            if self.art.layout is not None:  # the blocks of every rank
                from repro_torch.parallel import sharding as shd

                spec = dict(interop.tree_items(
                    self.art.layout.state_specs))[f"kv/{name}_scale"]
                s = shd.gather_leaf(s, spec, self.mesh)
            s = s.double().cpu()
            s = s[s != 1.0] if (s != 1.0).any() else s
            out[f"scale_{name}_mean"] = float(s.mean())
            out[f"scale_{name}_max"] = float(s.max())
        return out

    @property
    def finished(self) -> list[RequestState]:
        return self.sched.finished
