"""Distributed GEMM: the paper's array mapping (§4.2) at mesh scale (port of
``repro.core.distributed``), and the collectives the port runs.

``output_stationary_gemm``
    The paper's mapping verbatim, one mesh axis per array dimension: each
    rank takes its (M/m, K) block of A (A sharded M-over-``m_axis``,
    replicated over ``n_axis``: the broadcast of A tiles across a row of
    cores) and its (K, N/n) block of B (the column broadcast), keeps K
    whole and reduces it locally in time, and returns its (M/m, N/n) block
    of C. **No collective runs**: the mesh rendition of "all cores
    compute independently". The fused epilogue (bias, activation) stays
    local too: a rank adds its N block of the bias.

``k_sharded_gemm``
    The foil: K partitioned over ``k_axis`` (the Versal adder-tree analog),
    each rank's partial product in f32, one ``all_reduce`` (sum) over the
    axis, then the cast. It exists so that the roofline can price the
    collective the paper's mapping avoids.

Both take the global operands on every rank and run their local product
through ``core.gemm.balanced_gemm``: the hand-written ``matmul.cu`` on the
card. Neither uses a DTensor op (that would put the product on
``aten::mm``, a library call).

The collective helpers (``all_gather``, ``reduce_scatter``,
``all_reduce``, ``all_to_all``, ``broadcast``, ``send_recv``) are what
every sharded path of the port calls; they are not differentiable
(``parallel.fsdp.Gather`` is the gather autograd sees, and
:func:`exchange` the all-to-all). Each adds the bytes of its operand on
this rank (an all-gather's local block, a reduce-scatter's, all-reduce's
or all-to-all's whole input, a broadcast's tensor, a send's tensor) to the
active context's
:class:`CollectiveCounter` (the serving engine's clock, broadcast from
rank 0, under a kind of its own, ``clock``), the counterpart of the
reference's
``roofline.hlo.analyze(...).collective_bytes``. A MAX all-reduce
(:func:`scale_max`: a W8A8 activation, weight or KV-block scale over
the ranks that hold a share of its tensor) counts under ``scale_max``,
apart from the sums, so a quantized step's other collectives can be held
to the float step's. A collective over an axis
of extent 1 is skipped and counts 0, as XLA drops it. On an abstract mesh
(``launch.mesh.make_production_mesh``) the helpers take meta tensors,
return the shapes the collective would, and count the same bytes: the dry
run reckons a step's collectives by running it.

Under ``gloo`` (``launch.mesh.init_mesh(backend="gloo")``) a collective on
a CUDA tensor is staged through host memory: the operand is copied to the
host, the collective runs there and the result is copied back. It counts
the same bytes. This is the transport of several ranks on one card (NCCL
refuses two ranks on one GPU); the products stay on the card's kernels.

Tensor parallelism over 'model' (Megatron's design, in explicit
collectives) rests on three conjugate pairs, each an autograd Function
whose backward re-installs the forward's GEMM context:

``copy_to_model``
    forward the identity, backward an ``all_reduce`` over 'model': where a
    tensor whole on every rank feeds rank-local products;
``reduce_from_model``
    forward an ``all_reduce`` over 'model', backward the identity: where
    rank-local partial sums become the whole result again;
``gather_from_model`` / ``scatter_to_model``
    an ``all_gather`` along a dim and this rank's block of it, each the
    other's backward (``sum_grad``: the gather's backward reduce-scatters,
    for a result that each rank consumes in its own way).

``column_parallel`` (a product whose B is this rank's block of columns)
and ``row_parallel`` (of rows: f32 partials, one ``all_reduce``, then the
bias once and the cast, as in ``k_sharded_gemm``) are built on them. A
weight that a layer consumes as its 'model' block is marked so
(:func:`mark_model_block`, by ``parallel.fsdp.ShardPlan``).

W8A8 (a pre-quantized ``QuantizedLinear`` block, or a float one under
``quant_mode="int8"``) runs both: column-parallel through
``layers.quantized.qdense`` on this rank's N block of the int8 weight and
its scales, row-parallel through ``layers.quantized.row_parallel``: the
int8 product's int32 partials summed over 'model' (exact, in any order),
then the epilogue. The activation's per-tensor scale spans every rank
that holds a share of it (``layers.quantized.activation_scale``).
"""
from __future__ import annotations

import math
import threading

import torch
import torch.distributed as dist

from repro_torch.core.context import current_context, use_context
from repro_torch.core.gemm import balanced_gemm
from repro_torch.kernels.ops import GemmPlan
from repro_torch.quant.int8 import QuantizedLinear

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
         "send_recv", "broadcast", "clock", "scale_max")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class CollectiveCounter:
    """Bytes of the collectives run through the port's helpers, by
    kind. ``with CollectiveCounter() as c:`` installs it in a derived GEMM
    context for the block."""

    def __init__(self):
        self.bytes = dict.fromkeys(KINDS, 0)
        self._lock = threading.Lock()  # autograd's device thread adds too
        self._cm = None

    def add(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.bytes[kind] += int(nbytes)

    @property
    def total(self) -> int:
        return sum(self.bytes.values())

    def by_kind(self) -> dict[str, int]:
        return {k: v for k, v in self.bytes.items() if v}

    def __enter__(self) -> "CollectiveCounter":
        self._cm = use_context(collectives=self)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._cm.__exit__(*exc)
        self._cm = None


def _staged(mesh, t: torch.Tensor) -> bool:
    """A CUDA operand of a ``gloo`` collective: copied through the host."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _count(kind: str, t: torch.Tensor) -> None:
    counter = current_context().collectives
    if counter is not None:
        counter.add(kind, t.numel() * t.element_size())


def _check_abstract(mesh, t: torch.Tensor) -> None:
    if mesh.abstract and t.device.type != "meta":
        raise ValueError("an abstract mesh moves nothing: its collectives "
                         f"take meta tensors, not {t.device}")


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim``, in axis
    order."""
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    _check_abstract(mesh, t)
    _count("all_gather", t)
    x = t.detach().movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    if not mesh.abstract:
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        if _staged(mesh, x):
            host = torch.empty_like(out, device="cpu")
            gather(host, x.cpu(), group=mesh.group(axis))
            out.copy_(host)
        else:
            gather(out, x, group=mesh.group(axis))
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axis``."""
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    _check_abstract(mesh, t)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {axis} ({n})")
    _count("reduce_scatter", t)
    x = t.detach().movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    if not mesh.abstract:
        if _staged(mesh, x):
            host = torch.empty_like(out, device="cpu")
            dist.reduce_scatter_tensor(host, x.cpu(), op=dist.ReduceOp.SUM,
                                       group=mesh.group(axis))
            out.copy_(host)
        else:
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                       group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, mesh, axes, *, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (``op="max"``: the maximum, counted under ``scale_max``) of
    ``t`` over ``axes`` (one name or several, reduced one after another),
    in place where a collective runs."""
    for axis in (axes,) if isinstance(axes, str) else axes:
        if mesh.axis_size(axis) == 1:
            continue
        _check_abstract(mesh, t)
        _count("scale_max" if op == "max" else "all_reduce", t)
        if not mesh.abstract:
            t = t.contiguous()
            if _staged(mesh, t):
                host = t.cpu()
                dist.all_reduce(host, op=_OPS[op], group=mesh.group(axis))
                t.copy_(host)
            else:
                dist.all_reduce(t, op=_OPS[op], group=mesh.group(axis))
    return t


def scale_max(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The maximum of ``t`` (an absmax) over ``axes``, counted under
    ``scale_max``: the ranks that each hold a share of a tensor agree on
    its quantization scale. Exact in any order."""
    return all_reduce(t, mesh, axes, op="max")


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The tiled all-to-all over ``axis`` (``lax.all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``): dim 0 of ``t`` split into the axis's
    extent, block ``j`` sent to the rank at index ``j``, and the blocks
    received concatenated on dim 0 in source order. Its own inverse."""
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    _check_abstract(mesh, t)
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not split over "
                         f"{axis} ({n})")
    _count("all_to_all", t)
    x = t.detach().contiguous()
    out = torch.empty_like(x)
    if not mesh.abstract:
        if _staged(mesh, x):
            host = torch.empty_like(out, device="cpu")
            dist.all_to_all_single(host, x.cpu(), group=mesh.group(axis))
            out.copy_(host)
        else:
            dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def resplit(t: torch.Tensor, mesh, axis: str, have: int, want: int
            ) -> torch.Tensor:
    """``t``, this rank's block along dim ``have`` over ``axis``, as its
    block along dim ``want`` (whole along ``have``): one
    :func:`all_to_all` of ``t`` cut along ``want``, the blocks received
    joined along ``have`` in source order."""
    n = mesh.axis_size(axis)
    if n == 1 or have == want:
        return t
    if t.shape[want] % n:
        raise ValueError(f"dim {want} of {tuple(t.shape)} does not split "
                         f"over {axis} ({n})")
    x = t.unflatten(want, (n, t.shape[want] // n)).movedim(want, 0)
    return all_to_all(x.contiguous(), mesh, axis).movedim(0, have).flatten(
        have, have + 1)


def broadcast(t: torch.Tensor, mesh, axis: str, src: int,
              kind: str = "broadcast") -> torch.Tensor:
    """``t`` of the rank at ``src`` along ``axis``, on every rank of it (in
    place), counted under ``kind``."""
    if mesh.axis_size(axis) == 1:
        return t
    _check_abstract(mesh, t)
    _count(kind, t)
    if not mesh.abstract:
        if _staged(mesh, t):
            host = t.cpu()
            dist.broadcast(host, src=mesh.axis_ranks(axis)[src],
                           group=mesh.group(axis))
            t.copy_(host)
        else:
            dist.broadcast(t, src=mesh.axis_ranks(axis)[src],
                           group=mesh.group(axis))
    return t


def all_gather_over(t: torch.Tensor, mesh, entry, dim: int) -> torch.Tensor:
    """The blocks of a spec entry's axes (one name or several, major first)
    concatenated along ``dim``: an all-gather over each, minor axis first,
    as ``parallel.sharding.gather_leaf`` does."""
    for name in reversed(entry_axes(entry)):
        t = all_gather(t, mesh, name, dim)
    return t


def reduce_scatter_over(t: torch.Tensor, mesh, entry, dim: int
                        ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over a spec entry's axes:
    a reduce-scatter over each, major axis first."""
    for name in entry_axes(entry):
        t = reduce_scatter(t, mesh, name, dim)
    return t


def send_recv(send: torch.Tensor | None, dst: int | None,
              recv: torch.Tensor | None, src: int | None, mesh,
              axis: str) -> None:
    """Send ``send`` to the rank at index ``dst`` along ``axis`` and
    receive into ``recv`` from the one at ``src``, as one batch of
    point-to-point operations (``dist.batch_isend_irecv``). Either side may
    be None. Only sends are counted."""
    if mesh.axis_size(axis) == 1:
        return
    if send is not None:
        _check_abstract(mesh, send)
        _count("send_recv", send)
    if mesh.abstract:
        return
    ranks, group, ops = mesh.axis_ranks(axis), mesh.group(axis), []
    into = recv
    if send is not None:
        send = send.cpu() if _staged(mesh, send) else send.contiguous()
        ops.append(dist.P2POp(dist.isend, send, ranks[dst], group=group))
    if recv is not None:
        if _staged(mesh, recv):
            into = recv.cpu()
        ops.append(dist.P2POp(dist.irecv, into, ranks[src], group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if into is not recv:
        recv.copy_(into)


def local_block(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim`` over ``axis``."""
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {axis} ({n})")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axis) * size, size).contiguous()


def output_stationary_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh,
    *,
    m_axis: str = "data",
    n_axis: str = "model",
    bias: torch.Tensor | None = None,
    activation: str | None = None,
    out_dtype: torch.dtype | None = None,
    plan: GemmPlan | None = None,
) -> torch.Tensor:
    """This rank's (M/m, N/n) block of ``act(A @ B + bias)``: A[M, K]
    sharded on M, B[K, N] on N, K local (in time); zero collectives."""
    return balanced_gemm(
        local_block(a, 0, mesh, m_axis), local_block(b, 1, mesh, n_axis),
        None if bias is None else local_block(bias, 0, mesh, n_axis),
        activation=activation, out_dtype=out_dtype, plan=plan)


def k_sharded_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh,
    *,
    k_axis: str = "model",
    out_dtype: torch.dtype | None = None,
    plan: GemmPlan | None = None,
) -> torch.Tensor:
    """The Versal-style foil: K partitioned in space, the f32 partials
    summed by one all-reduce, then cast; C[M, N] whole on every rank."""
    part = balanced_gemm(local_block(a, 1, mesh, k_axis),
                         local_block(b, 0, mesh, k_axis),
                         out_dtype=torch.float32, plan=plan)
    part = all_reduce(part, mesh, k_axis)
    return part.to(out_dtype or a.dtype)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of a spec entry: an axis name, a tuple of them (major
    first), or None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_extent(mesh, entry) -> int:
    """The extent of a spec entry (1 for None)."""
    return math.prod(mesh.axis_size(n) for n in entry_axes(entry))


def entry_index(mesh, entry) -> int:
    """This rank's block index along a dim split over a spec entry's axes
    (major first)."""
    index = 0
    for name in entry_axes(entry):
        index = index * mesh.axis_size(name) + mesh.axis_index(name)
    return index


def data_parallel(mesh) -> tuple[object, int, int]:
    """The DP axes' spec entry (``batch_specs``' entry: one name, a tuple
    major first, or None), their extent and this rank's index over
    them."""
    dp = mesh.dp_axes()
    entry = (dp if len(dp) > 1 else dp[0]) if dp else None
    return entry, axes_extent(mesh, entry), entry_index(mesh, entry)


# ---------------------------------------------------- tensor parallelism
_BLOCK_DIM = "_repro_model_block_dim"


def mark_model_block(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Mark ``t`` as this rank's block of a leaf split along ``dim`` over
    'model', which the layer consuming it computes with as it is."""
    setattr(t, _BLOCK_DIM, dim)
    return t


def model_block_dim(t) -> int | None:
    """The dim a marked 'model' block is split along (None: whole). A
    ``QuantizedLinear`` answers for its int8 (..., N, K) weight in the
    float weight's (..., K, N) terms: 1 for a block of columns, 0 of
    rows."""
    if isinstance(t, QuantizedLinear):
        dim = model_block_dim(t.w_q)
        if dim is None:
            return None
        nd = t.w_q.dim()
        return {nd - 2: nd - 1, nd - 1: nd - 2}.get(dim, dim)
    return None if t is None else getattr(t, _BLOCK_DIM, None)


def in_features(w) -> int:
    """K of a float (K, N) weight or of a ``QuantizedLinear``'s (N, K)."""
    return w.w_q.shape[-1] if isinstance(w, QuantizedLinear) else w.shape[-2]


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.gemm_context = mesh, current_context()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with use_context(ctx.gemm_context):
            return all_reduce(g.clone(memory_format=torch.contiguous_format),
                              ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, sum_grad):
        ctx.args, ctx.gemm_context = (mesh, dim, sum_grad), current_context()
        return all_gather(x, mesh, "model", dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, dim, sum_grad = ctx.args
        with use_context(ctx.gemm_context):
            if sum_grad:
                return reduce_scatter(g, mesh, "model", dim), None, None, None
            return local_block(g, dim, mesh, "model"), None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args, ctx.gemm_context = (mesh, dim), current_context()
        return local_block(x, dim, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.args
        with use_context(ctx.gemm_context):
            return all_gather(g, mesh, "model", dim).contiguous(), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args, ctx.gemm_context = (mesh, axis), current_context()
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        with use_context(ctx.gemm_context):
            return all_to_all(g, mesh, axis), None, None


class _ReduceScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args, ctx.gemm_context = (mesh, dim), current_context()
        return reduce_scatter(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.args
        with use_context(ctx.gemm_context):
            return all_gather(g, mesh, "model", dim).contiguous(), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, n):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axes) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`all_to_all` under autograd: the tiled exchange is its own
    transpose, so its backward is the same exchange of the gradient."""
    if mesh.axis_size(axis) == 1:
        return x
    if not _recorded(x):
        return all_to_all(x, mesh, axis)
    return _Exchange.apply(x, mesh, axis)


def reduce_scatter_to_model(x: torch.Tensor, mesh, dim: int
                            ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over 'model' of the
    ranks' ``x`` (a reduce-scatter); backward the gradient's blocks
    gathered along ``dim``."""
    if mesh.axis_size("model") == 1:
        return x
    dim %= x.dim()
    if not _recorded(x):
        return reduce_scatter(x, mesh, "model", dim)
    return _ReduceScatterToModel.apply(x, mesh, dim)


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean over ``axes`` of the ranks' ``x`` (the reference's
    ``pmean``); backward the identity: each rank's gradient then carries
    its own term, and the DP mean of the gradients (``parallel.fsdp``)
    makes it the mean's."""
    axes = [a for a in axes if mesh.axis_size(a) > 1]
    if not axes:
        return x
    n = math.prod(mesh.axis_size(a) for a in axes)
    if not _recorded(x):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axes) / n
    return _MeanOver.apply(x, mesh, axes, n)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, whole on every rank of 'model', as the input of rank-local
    work: the identity forward; backward the sum over 'model' of the
    ranks' gradients."""
    if mesh.axis_size("model") == 1 or not _recorded(x):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over 'model' of the ranks' ``x`` (an ``all_reduce``; without
    a recorded gradient, in place); backward the identity."""
    if mesh.axis_size("model") == 1:
        return x
    if not _recorded(x):
        return all_reduce(x, mesh, "model")
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int,
                      sum_grad: bool = False) -> torch.Tensor:
    """The ranks' blocks of 'model' concatenated along ``dim``; backward
    this rank's block of the gradient (every rank consumes the whole alike)
    or, with ``sum_grad``, of the gradients summed over 'model' (a
    reduce-scatter: each rank consumes the whole in its own way)."""
    if mesh.axis_size("model") == 1:
        return x
    dim %= x.dim()
    if not _recorded(x):
        return all_gather(x, mesh, "model", dim).contiguous()
    return _GatherFromModel.apply(x, mesh, dim, sum_grad)


def scatter_to_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` (whole on every rank of
    'model'); backward the ranks' gradients gathered along ``dim``."""
    if mesh.axis_size("model") == 1:
        return x
    dim %= x.dim()
    if not _recorded(x):
        return local_block(x, dim, mesh, "model")
    return _ScatterToModel.apply(x, mesh, dim)


def is_w8a8(x: torch.Tensor, w) -> bool:
    """Whether ``x @ w`` takes the W8A8 path: a pre-quantized weight, or a
    float one under ``quant_mode="int8"``."""
    return isinstance(w, QuantizedLinear) or (
        current_context().quant_mode == "int8" and x.is_floating_point())


def local_gemm(x: torch.Tensor, w, bias=None, *,
               activation: str | None = None,
               out_dtype: torch.dtype | None = None,
               b_layout: str = "row", split=()) -> torch.Tensor:
    """One rank's product of a tensor-parallel pair, on the planned
    kernels. A ``QuantizedLinear`` (this rank's N block, or whole) and,
    under ``quant_mode="int8"``, a float row-layout ``w`` take the W8A8
    path (``layers.quantized.w8a8``), whose activation scale spans the DP
    ranks where the step's rows are cut and ``split``: the other mesh axes
    that split ``x``'s elements (attention's 'seq' mode: its rows over
    'model')."""
    if b_layout == "row" and is_w8a8(x, w):
        from repro_torch.layers import quantized as lq

        return lq.w8a8(x, w, bias, activation=activation,
                       out_dtype=out_dtype, scale_over=split)
    return balanced_gemm(x, w, bias, activation=activation,
                         out_dtype=out_dtype or x.dtype, b_layout=b_layout)


def column_parallel(x: torch.Tensor, w_block: torch.Tensor, bias=None, *,
                    mesh, activation: str | None = None,
                    out_dtype: torch.dtype | None = None,
                    b_layout: str = "row") -> torch.Tensor:
    """This rank's block of columns of ``act(x @ W + bias)``: ``x`` whole
    (:func:`copy_to_model`), ``w_block`` and ``bias`` this rank's blocks
    along N, the epilogue fused."""
    return local_gemm(copy_to_model(x, mesh), w_block, bias,
                      activation=activation, out_dtype=out_dtype,
                      b_layout=b_layout)


def row_parallel(h_block: torch.Tensor, w_block, bias=None,
                 *, mesh, out_dtype: torch.dtype | None = None
                 ) -> torch.Tensor:
    """``h @ W + bias`` whole on every rank from this rank's blocks along K
    (``h_block``'s columns, ``w_block``'s rows): the local product in f32,
    summed over 'model' (:func:`reduce_from_model`), then the bias once,
    then the cast. W8A8: ``layers.quantized.row_parallel``."""
    if is_w8a8(h_block, w_block):
        from repro_torch.layers import quantized as lq

        return lq.row_parallel(h_block, w_block, bias, mesh=mesh,
                               out_dtype=out_dtype or h_block.dtype)
    part = local_gemm(h_block, w_block, out_dtype=torch.float32)
    part = reduce_from_model(part, mesh)
    if bias is not None:
        part = part + bias.float()
    return part.to(out_dtype or h_block.dtype)
