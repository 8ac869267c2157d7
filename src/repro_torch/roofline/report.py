"""Roofline report: dry-run records -> markdown tables (port of
``repro.roofline.report``).

Per (arch x shape x mesh) cell, against a hardware generation (``--hw``,
default the execution context's: ``h100``, 989 TFLOP/s bf16, 3.35 TB/s
HBM, 450 GB/s NVLink each way):

  compute term    = flops_per_device / peak FLOP/s
  memory term     = bytes_per_device / HBM rate
  collective term = collective_bytes_per_device / link rate

The dry run's counts are per device (one rank's step), so chips=1 in the
formulas. Its bytes are the GEMMs' only (``bytes_scope: "gemm"``), so the
memory term is a floor. MODEL_FLOPS is the standard accounting: 6 N D
training (forward and backward), 2 N D prefill, 2 N B decode, N the
non-embedding parameters (the active share for MoE).
"""
from __future__ import annotations

import glob
import json
import os

import torch

from repro_torch import configs as C
from repro_torch import models
from repro_torch.configs.base import SHAPES
from repro_torch.core.context import resolve_hw, use_context
from repro_torch.core.perfmodel import roofline_terms

SUGGESTIONS = {
    "compute_low_useful": (
        "compute-bound with low useful-FLOP ratio: cut remat recompute "
        "(selective checkpointing) or drop the attention-chunk inner remat"),
    "compute": (
        "compute-bound near the useful-FLOP ceiling: larger per-device batch "
        "or faster kernels (the balanced GEMM kernels) is the only lever"),
    "memory_decode": (
        "HBM-bound on weight/cache streaming: quantize KV cache or batch "
        "more decode requests per step"),
    "memory": (
        "HBM-bound: raise arithmetic intensity — fuse ops (CUDA kernels), "
        "larger microbatches, or bf16ify remaining f32 traffic"),
    "collective": (
        "collective-bound: overlap collectives with compute (async), shrink "
        "TP degree for this layer mix, or move the psum to a reduce-scatter "
        "+ fused epilogue"),
}


# the dry run's collective kinds (``core.distributed.KINDS``) under the
# names the reference's HLO analyzer gives the same operations
# (``repro.roofline.hlo.COLLECTIVES``); the port's own kinds keep theirs
HLO_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
             "send_recv": "collective-permute"}


def by_collective(rec: dict) -> dict[str, int]:
    """A record's collective bytes by kind, under the reference's names."""
    return {HLO_NAMES.get(k, k): v
            for k, v in rec["cost"]["by_collective"].items()}


def _ref_keys(tree, keys=()):
    """(key, leaf) pairs with the reference's key rule: dict keys joined by
    '/', a NamedTuple field contributing an empty part (its path entry has
    no ``key``)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _ref_keys(v, keys + (str(k),))
    elif hasattr(tree, "_fields"):
        for v in tree:
            yield from _ref_keys(v, keys + ("",))
    else:
        yield "/".join(keys), tree


def _param_counts(cfg) -> tuple[int, int]:
    """(total_non_embedding, active_non_embedding) parameter counts."""
    total = active = 0
    for key, leaf in _ref_keys(models.init(cfg, device="meta")):
        if "embed" in key.split("/")[0]:  # embed/unembed tables
            continue
        n = leaf.numel()
        total += n
        if cfg.family == "moe" and ("/moe/" in key or key.endswith("w_in")
                                    or "w_gate" in key or "w_out" in key) \
                and "mlp" not in key:
            # expert weights: only top_k / n_experts active per token
            active += n * cfg.top_k // max(cfg.n_experts, 1)
        else:
            active += n
    return total, active


def model_flops(cfg, shape) -> float:
    """Standard 6ND / 2ND / 2NB accounting (global, per step)."""
    _, n = _param_counts(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token a sequence


def load_records(dryrun_dir: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def enrich(rec: dict, hw=None) -> dict:
    """Attach the roofline terms and the model-FLOPs ratio to one dry-run
    record, against the given (or context-active) hardware generation."""
    if rec["status"] != "ok":
        return rec
    hw = resolve_hw(hw)
    cfg = C.get_config(rec["arch"])
    cost = rec["cost"]
    dtype = torch.bfloat16
    rt = roofline_terms(hw, flops=cost["flops_per_device"],
                        hbm_bytes=cost["bytes_per_device"],
                        collective_bytes=cost["collective_bytes_per_device"],
                        chips=1, dtype=dtype)
    mf = model_flops(cfg, SHAPES[rec["shape"]])
    counted_global = cost["flops_per_device"] * rec["chips"]
    peak = rec["chips"] * hw.dense_peak(dtype)
    rec["roofline"] = {
        "hw": hw.name,
        "compute_s": rt.compute,
        "memory_s": rt.memory,
        "collective_s": rt.collective,
        "dominant": rt.dominant,
        "bound_s": rt.bound,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / counted_global if counted_global
                               else float("nan")),
        # the share of the all-overlap step bound that is compute
        "roofline_fraction": rt.compute / rt.bound if rt.bound else 0.0,
        "model_time_s": mf / peak,
        # MFU if the step ran exactly at the overlap bound
        "mfu_at_bound": mf / peak / rt.bound if rt.bound else 0.0,
    }
    return rec


def suggestion(rec: dict) -> str:
    """One sentence on what would move the dominant term down."""
    r = rec.get("roofline")
    if not r:
        return ""
    dom = r["dominant"]
    if dom == "compute":
        return SUGGESTIONS["compute_low_useful" if r["useful_flops_ratio"]
                           < 0.45 else "compute"]
    if dom == "memory":
        return SUGGESTIONS["memory_decode" if rec["kind"] == "decode"
                           else "memory"]
    return SUGGESTIONS["collective"]


def markdown_tables(recs: list[dict], hw=None) -> str:
    hw = resolve_hw(hw)
    recs = [enrich(dict(r), hw=hw) for r in recs]
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = [r for r in recs if r["status"] == "skipped"]

    out = ["### Dry-run results (all cells, meta device)\n",
           "| arch | shape | mesh | wall s | state GiB/dev | GFLOP/dev | "
           "GEMM GB/dev | coll. MB/dev | top collectives |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        c = r["cost"]
        colls = sorted(by_collective(r).items(), key=lambda kv: -kv[1])[:2]
        cstr = ", ".join(f"{k} {v/1e6:.0f}MB" for k, v in colls) or "none"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['wall_s']:.1f} "
            f"| {r['memory']['state_gib_per_device']:.3f} "
            f"| {c['flops_per_device']/1e9:.1f} "
            f"| {c['bytes_per_device']/1e9:.2f} "
            f"| {c['collective_bytes_per_device']/1e6:.1f} | {cstr} |")
    out.append("")
    if skipped:
        out.append("Skipped cells (assignment rules):\n")
        for r in sorted(skipped, key=lambda r: (r["arch"], r["shape"],
                                                r["mesh"])):
            out.append(f"- {r['arch']} × {r['shape']} × {r['mesh']}: "
                       f"{r['reason']}")
    out.append("")
    out += [f"### Roofline terms (single-pod 16×16, per device, {hw.name})\n",
            "| arch | shape | compute ms | memory ms | collective ms | "
            "dominant | 6ND/counted | roofline frac | MFU@bound | "
            "what would move the dominant term |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    out += [roofline_row(r) for r in sorted(ok, key=lambda r: (
        r["arch"], r["shape"])) if r["mesh"] == "16x16"]
    out.append("")
    return "\n".join(out)


def roofline_row(r: dict) -> str:
    """One enriched record's row of the roofline table."""
    rf = r["roofline"]
    return (f"| {r['arch']} | {r['shape']} "
            f"| {rf['compute_s']*1e3:.2f} | {rf['memory_s']*1e3:.2f} "
            f"| {rf['collective_s']*1e3:.3f} | **{rf['dominant']}** "
            f"| {rf['useful_flops_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.2f} | {rf['mfu_at_bound']:.2f} "
            f"| {suggestion(r)} |")


def main(argv: list[str] | None = None) -> None:
    import argparse

    from repro_torch.launch.dryrun import OUT_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=OUT_DIR)
    ap.add_argument("--out", default=None)
    ap.add_argument("--hw", default=None,
                    help="hardware generation for the roofline constants")
    args = ap.parse_args(argv)
    with use_context(hw=resolve_hw(args.hw)):
        md = markdown_tables(load_records(args.dryrun_dir))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    else:
        print(md)


if __name__ == "__main__":
    main()
