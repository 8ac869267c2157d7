"""Dry run on the meta device: every (arch x shape x mesh) cell, reckoned
per device (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder devices and
reads XLA's memory and cost analyses and its HLO. The port has no compiler
to ask, so it runs the cell: on the meta device (shapes and dtypes, no
storage, no arithmetic) and on the abstract production mesh
(``launch.mesh.make_production_mesh``: this rank at the origin, the
collective helpers counting bytes and moving nothing). Per cell:

* **state bytes per device**, exact: one rank's blocks
  (``parallel.sharding.local_shape``) of the params and the optimizer
  state (train: ``param_specs``, ``trainstep.opt_spec_like``) or of the
  params and the decode state (prefill, decode: ``decode_state_specs``);
* **FLOPs and bytes per device**: the step run once at its per-rank local
  batch (train: the sharded step, forward and backward and its optimizer;
  prefill and decode: the serve steps). The GEMMs are counted from the
  signatures the dispatch sees (``core.gemm``'s dispatch listeners, as
  ``obs.attrib`` captures a step profile): 2 M K N operations and their
  bytes, A and C at their dtypes, B as the perf model reckons it (a float
  B on a GPU at 4 bytes: the plan key records only A's dtype). The other
  aten ops (attention's products, the MoE experts' batched matmuls) are
  counted by ``torch.utils.flop_counter.FlopCounterMode``; their bytes
  are not reckoned (``bytes_scope: "gemm"``);
* **collective bytes per device**, by kind: what the sharded steps run
  (the counter of ``core.distributed``): the train step's gathers and
  reductions (``parallel.fsdp``) and its tensor-parallel collectives over
  'model'; the serve steps' (``train.servestep.make_serve_step`` over the
  mesh: the layers' leaves gathered over the DP axes, tensor-parallel over
  'model', the decode state in ``decode_state_specs``' blocks), and the
  serving engine's steps (:func:`engine_cells`: the tick, each chunk
  bucket or the admission, the verify pass and the draft's steps);
* the wall seconds of the cell.

Every family's serve cells are counted: the rwkv and hybrid families'
layers are tensor-parallel over 'model' and read and write their decode
states' blocks (an all-to-all takes the WKV state, whose key dim the
reference's rule splits over 'model', to this rank's heads and back).
The hybrid family's train and prefill cells are counted like every
other: its SSM scan runs in chunks of 64 tokens.

One JSON per cell under ``--out`` (default ``build/dryrun``, which git
ignores); the exit code is 1 if any cell errs. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as C
from repro_torch import models
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core import gemm
from repro_torch.core.context import resolve_hw, use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.core.perfmodel import itemsize
from repro_torch.interop import tree_items
from repro_torch.launch.args import add_context_args, context_from_args
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.train import servestep, trainstep

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT_DIR = os.path.join(ROOT, "build", "dryrun")
MESH_NAMES = {False: "16x16", True: "2x16x16"}

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def count_step(fn) -> dict:
    """Run ``fn`` once, counting its GEMMs, its other aten FLOPs and its
    collectives."""
    gemms = {"calls": 0, "flops": 0, "bytes": 0}

    def listener(key, plan):
        hw_name, M, K, N, a_dt, out_dt, _ = key
        ty_a = itemsize(a_dt)
        gemms["calls"] += 1
        gemms["flops"] += 2 * M * K * N
        gemms["bytes"] += (M * K * ty_a
                           + K * N * resolve_hw(hw_name).b_itemsize(ty_a)
                           + M * N * itemsize(out_dt))

    gemm.add_dispatch_listener(listener)
    try:
        with CollectiveCounter() as coll, \
                FlopCounterMode(display=False) as flops:
            fn()
    finally:
        gemm.remove_dispatch_listener(listener)
    other = flops.get_total_flops()
    return {
        "flops_per_device": gemms["flops"] + other,
        "gemm_flops_per_device": gemms["flops"],
        "other_flops_per_device": other,
        "bytes_per_device": gemms["bytes"],
        "bytes_scope": "gemm",
        "gemm_calls": gemms["calls"],
        "collective_bytes_per_device": coll.total,
        "by_collective": coll.by_kind(),
    }


def _tree_bytes(tree, shardings) -> int:
    sh = dict(tree_items(shardings))
    return sum(shd.local_bytes(t, sh[p].spec, sh[p].mesh)
               for p, t in tree_items(tree))


def _spec_bytes(tree, specs, mesh) -> int:
    sp = dict(tree_items(specs))
    return sum(shd.local_bytes(t, sp[p], mesh) for p, t in tree_items(tree))


def _local_batch(mesh, batch: int) -> int:
    """The batch one rank runs (``batch_specs``: split over the DP axes
    where they divide it)."""
    dp = math.prod(mesh.axis_size(a) for a in mesh.dp_axes())
    return batch // dp if batch % dp == 0 else batch


def train_state(cfg, mesh, global_batch: int, seq_len: int, opt_cfg=None):
    """The sharded step's artifacts on ``mesh`` and one rank's state bytes
    (params and optimizer state)."""
    art = trainstep.make_train_step(cfg, opt_cfg, mesh=mesh,
                                    global_batch=global_batch,
                                    seq_len=seq_len)
    sh = art.state_shardings
    params = _tree_bytes(art.state_shapes["params"], sh["params"])
    opt = _tree_bytes(art.state_shapes["opt"], sh["opt"])
    return art, {"param_bytes_per_device": params,
                 "opt_bytes_per_device": opt,
                 "state_bytes_per_device": params + opt}


def serve_state(cfg, mesh, batch: int, seq_len: int):
    """The params (meta) and one rank's state bytes for serving: its blocks
    of the params and of the decode state of ``batch`` x ``seq_len``."""
    params = models.init(cfg, device="meta")
    pspecs = shd.param_specs(models.axes(cfg), params, mesh)
    full_state = models.init_decode_state(cfg, batch, seq_len, device="meta")
    sspecs = shd.decode_state_specs(full_state, cfg, mesh)
    p_bytes = _spec_bytes(params, pspecs, mesh)
    s_bytes = _spec_bytes(full_state, sspecs, mesh)
    return params, {"param_bytes_per_device": p_bytes,
                    "decode_state_bytes_per_device": s_bytes,
                    "state_bytes_per_device": p_bytes + s_bytes}


def train_cell(cfg, mesh, global_batch: int, seq_len: int,
               opt_cfg=None) -> dict:
    """The sharded train step of ``cfg`` on ``mesh`` (abstract), once on
    the meta device, from a global batch of ``global_batch`` x
    ``seq_len``."""
    art, memory = train_state(cfg, mesh, global_batch, seq_len, opt_cfg)
    state = art.init_fn(0)
    batch = {k: _meta(s, dt) for k, (s, dt) in trainstep.input_shapes(
        cfg, global_batch, seq_len).items()}
    cost = count_step(lambda: art.step_fn(state, batch))
    cost["collective_plan"] = ("fsdp: stacked leaves gathered a layer at a "
                               "time, the rest once a step; gradients "
                               "reduced over the DP axes")
    return {"local_batch": _local_batch(mesh, global_batch),
            "microbatches": art.microbatches, "memory": memory,
            "cost": cost}


def serve_cell(cfg, mesh, kind: str, batch: int, seq_len: int) -> dict:
    """The sharded serve step (prefill of ``seq_len`` tokens, or one decode
    step against a ``seq_len`` cache) over ``mesh`` on the meta device:
    this rank's blocks of the params and of the decode state, its rows of
    the batch; the state bytes from the params' and decode state's
    specs."""
    params, memory = serve_state(cfg, mesh, batch, seq_len)
    art = servestep.make_serve_step(cfg, device="meta", mesh=mesh,
                                    batch=batch, max_len=seq_len)
    params = art.shard_params(params)
    state = art.init_state(batch, seq_len)
    if kind == "prefill":
        inputs = art.rows({k: _meta(s, dt) for k, (s, dt) in
                           servestep.prefill_input_shapes(
                               cfg, batch, seq_len).items()})
        fn = lambda: art.prefill_fn(params, state, inputs)
    else:
        tok = art.rows({"t": _meta((batch, 1), torch.int64)})["t"]
        fn = lambda: art.decode_raw(params, state, tok)
    cost = count_step(fn)
    cost["collective_plan"] = ("tensor parallel over 'model' (column / row "
                               "pairs, vocab-parallel embed and unembed; a "
                               "cache's sequence over 'model': its softmax's "
                               "max and sum gathered, its weighted V summed); "
                               "the layers' leaves "
                               "gathered over the DP axes a layer at a time")
    return {"local_batch": _local_batch(mesh, batch), "memory": memory,
            "cost": cost}


def engine_cells(cfg, mesh, *, num_slots: int, max_len: int,
                 prompt_pad: int, kv_block_size: int | None = None,
                 num_kv_blocks: int | None = None,
                 prefill_chunk: int | None = None, kv_dtype=None,
                 draft_cfg=None, spec_k: int = 4) -> dict[str, dict]:
    """The serving engine's steps over ``mesh`` (abstract) on the meta
    device, each counted once (:func:`count_step`), by the engine's phase
    tags: the tick at ``num_slots`` lanes ("decode"), the paged engine's
    chunk at each bucket ("prefill-chunk@<bucket>") or the contiguous
    engine's admission ("admit"), and with a ``draft_cfg`` the verify pass
    ("spec-verify"), the draft's admission ("admit") and its propose step
    ("spec-draft"). The defaults are ``serve.ServeEngine``'s (the pool at
    full contiguous capacity, chunks of ``prompt_pad``); the params are
    each model's from seed 0, this rank's blocks. Each cell's collective
    bytes are what a rank's step moves over a real mesh of that shape."""
    from repro_torch.serve.engine import chunk_buckets

    meta = lambda shape: _meta(shape, torch.int64)
    one = lambda: _meta((), torch.int64)
    cells = {}
    if kv_block_size:
        blocks = num_kv_blocks or -(-num_slots * max_len // kv_block_size) + 1
        art = servestep.make_paged_engine_step(
            cfg, num_slots=num_slots, max_len=max_len,
            kv_block_size=kv_block_size, num_kv_blocks=blocks,
            chunk_buckets=chunk_buckets(prefill_chunk or prompt_pad),
            device="meta", kv_dtype=kv_dtype, mesh=mesh)
    else:
        art = servestep.make_engine_step(
            cfg, num_slots=num_slots, max_len=max_len,
            prompt_pad=prompt_pad, device="meta", mesh=mesh)
    params = art.layout.shard_params(models.init(cfg, device="meta"))
    state = art.init_state("meta")
    toks, active = meta((num_slots, 1)), meta((num_slots,))
    if kv_block_size:
        for b in art.chunk_buckets:
            cells[f"prefill-chunk@{b}"] = count_step(lambda: art.prefill_raw(
                params, state, meta((1, b)), one(), one(), one(),
                meta((art.max_blocks,))))
    else:
        cells["admit"] = count_step(lambda: art.admit_raw(
            params, state, meta((1, prompt_pad)), one(), one()))
    cells["decode"] = count_step(lambda: art.decode_raw(params, state, toks,
                                                        active))
    if draft_cfg is not None:
        spec = servestep.make_spec_step(
            cfg, draft_cfg, num_slots=num_slots, max_len=max_len,
            prompt_pad=prompt_pad, spec_k=spec_k, device="meta", mesh=mesh,
            target=art)
        dparams = spec.draft_layout.shard_params(models.init(draft_cfg,
                                                             device="meta"))
        dstate = spec.init_draft_state("meta")
        cells["spec-verify"] = count_step(lambda: spec.verify_raw(
            params, state, meta((num_slots, spec_k + 1)), active))
        cells["admit"] = count_step(lambda: spec.draft_admit_raw(
            dparams, dstate, meta((1, prompt_pad)), one(), one()))
        cells["spec-draft"] = count_step(lambda: spec.propose_raw(
            dparams, dstate, toks, active, toks, active))
    return cells


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str
             ) -> dict:
    cfg = C.get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    tag = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH_NAMES[multi_pod],
           "chips": mesh.size, "kind": shape.kind}
    ok, why = shape_applicable(cfg, shape)
    t0 = time.perf_counter()
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        try:
            if shape.kind == "train":
                rec.update(train_cell(cfg, mesh, shape.global_batch,
                                      shape.seq_len))
            else:
                rec.update(serve_cell(cfg, mesh, shape.kind,
                                      shape.global_batch, shape.seq_len))
            rec["status"] = "ok"
        except NotImplementedError as e:  # a path the port lacks, named
            rec.update(status="skipped", reason=str(e))
        except Exception as e:  # a failure here is a bug in the port
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-4000:])
    rec["wall_s"] = time.perf_counter() - t0
    if rec["status"] == "ok":
        rec["memory"]["state_gib_per_device"] = \
            rec["memory"]["state_bytes_per_device"] / 2**30
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    cost = rec.get("cost", {})
    print(f"[{rec['status']:>7}] {arch} x {shape_name} x {tag} "
          f"{rec['wall_s']:.1f}s state="
          f"{rec.get('memory', {}).get('state_gib_per_device', '-')}GiB "
          f"flops={cost.get('flops_per_device', '-')} "
          f"collective={cost.get('collective_bytes_per_device', '-')}",
          flush=True)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    add_context_args(ap, include_quant=False)
    ap.set_defaults(plan_cache="")  # in memory: the dry run keeps no plans
    args = ap.parse_args(argv)

    archs = C.list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    failures = 0
    with use_context(context_from_args(args)):
        for arch in archs:
            for shape_name in shapes:
                for multi in meshes:
                    rec = run_cell(arch, shape_name, multi, args.out)
                    failures += rec["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
