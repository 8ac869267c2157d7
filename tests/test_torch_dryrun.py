"""The port's dry run (meta device) and roofline report against the
reference's, on the CPU.

* the per-device state bytes of every arch x shape on the 16 x 16 mesh
  (train: params and optimizer state; prefill and decode: params and
  decode state) equal the same sum over the reference's own specs (its
  ``make_train_step`` state shardings on an abstract mesh,
  ``param_specs`` and ``decode_state_specs``);
* ``model_flops``, ``roofline_terms``, ``gemm_tops`` (at one chip and
  over a mesh), ``enrich``, ``suggestion`` and the roofline table's rows
  equal the reference's for the same records and ``HardwareSpec`` numbers
  (``tpu_v6e`` and ``tpu_v5e`` are in both registries). The one wording
  the port changes: the reference's suggestions name Pallas kernels;
* one full meta dry-run cell runs in under 60 s, and the CLI writes its
  record and renders the tables from it;
* the MoE cells (olmoe-1b-7b, arctic-480b) run expert parallelism: their
  all-to-alls counted, their expert tables kept as blocks.

Byte counts and FLOP counts are integers compared exactly; the roofline
terms are float quotients of the same numbers, compared to rtol 1e-12.
"""
import dataclasses
import json
import math
import os
import types

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, AxisType

from repro import configs as RC
from repro import models as rmodels
from repro.core import hwregistry as rhw
from repro.core import perfmodel as rpm
from repro.parallel import sharding as rshd
from repro.roofline import report as rreport
from repro.train import trainstep as rtrain
from repro_torch import configs as C
from repro_torch.core import hwregistry as thw
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.core import perfmodel as tpm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import report

ARCHS = C.list_archs()


class _RefMesh(AbstractMesh):
    """An abstract 16 x 16 mesh the reference's step factory accepts (its
    ``mesh_axis_sizes`` reads ``devices.shape``)."""

    @property
    def devices(self):
        return types.SimpleNamespace(shape=self.axis_sizes)


REF_MESH = _RefMesh((16, 16), ("data", "model"),
                    axis_types=(AxisType.Auto,) * 2)
SIZES = {"data": 16, "model": 16}


def _ref_local_bytes(sds, spec) -> int:
    n = 1
    for i, dim in enumerate(sds.shape):
        e = spec[i] if i < len(spec) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        n *= dim // math.prod(SIZES[x] for x in names)
    return n * np.dtype(sds.dtype).itemsize


def _ref_tree_bytes(shapes, specs) -> int:
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    return sum(_ref_local_bytes(s, p) for s, p in zip(
        jax.tree.leaves(shapes), jax.tree.leaves(specs, is_leaf=is_spec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_bytes_match_reference(arch):
    shape = C.SHAPES["train_4k"]
    art = rtrain.make_train_step(RC.get_config(arch), REF_MESH,
                                 global_batch=shape.global_batch,
                                 seq_len=shape.seq_len)
    specs = jax.tree.map(lambda s: s.spec, art.state_shardings,
                         is_leaf=lambda s: hasattr(s, "spec"))
    ref_params = _ref_tree_bytes(art.state_shapes["params"], specs["params"])
    ref_opt = _ref_tree_bytes(art.state_shapes["opt"], specs["opt"])
    _, got = dryrun.train_state(C.get_config(arch), make_production_mesh(),
                                shape.global_batch, shape.seq_len)
    assert got["param_bytes_per_device"] == ref_params
    assert got["opt_bytes_per_device"] == ref_opt


SERVE_CELLS = [(a, s) for a in ARCHS for s in ("prefill_32k", "decode_32k",
                                                "long_500k")
               if C.shape_applicable(C.get_config(a), C.SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_serve_state_bytes_match_reference(arch, shape):
    s = C.SHAPES[shape]
    rcfg, cfg = RC.get_config(arch), C.get_config(arch)
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=types.SimpleNamespace(
                                     shape=(16, 16)))
    pshapes = jax.eval_shape(lambda: rmodels.init(jax.random.PRNGKey(0),
                                                  rcfg))
    sshapes = jax.eval_shape(lambda: rmodels.init_decode_state(
        rcfg, s.global_batch, s.seq_len))
    ref_p = _ref_tree_bytes(pshapes, rshd.param_specs(rmodels.axes(rcfg),
                                                      pshapes, fake))
    ref_s = _ref_tree_bytes(sshapes, rshd.decode_state_specs(sshapes, rcfg,
                                                             fake))
    _, got = dryrun.serve_state(cfg, make_production_mesh(), s.global_batch,
                                s.seq_len)
    assert got["param_bytes_per_device"] == ref_p
    assert got["decode_state_bytes_per_device"] == ref_s


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    rcfg, cfg = RC.get_config(arch), C.get_config(arch)
    assert report._param_counts(cfg) == rreport._param_counts(rcfg)
    for name in C.SHAPES:
        assert report.model_flops(cfg, C.SHAPES[name]) == \
            rreport.model_flops(rcfg, RC.SHAPES[name])


@pytest.mark.parametrize("hw", ["tpu_v6e", "tpu_v5e"])
def test_roofline_terms_and_gemm_tops_match_reference(hw):
    rh, th = rhw.get_hw(hw), thw.get_hw(hw)
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c = (float(x) for x in rng.uniform(1e9, 1e15, size=3))
        chips = int(rng.choice([1, 8, 256]))
        r = rpm.roofline_terms(rh, hlo_flops=f, hlo_bytes=b,
                               collective_bytes=c, chips=chips)
        t = tpm.roofline_terms(th, flops=f, hbm_bytes=b, collective_bytes=c,
                               chips=chips)
        np.testing.assert_allclose(
            [t.compute, t.memory, t.collective, t.bound],
            [r.compute, r.memory, r.collective, r.bound], rtol=1e-12)
        assert t.dominant == r.dominant
    for M, K, N, bm, bk, bn in [(512, 2560, 2560, 256, 512, 256),
                                (4096, 4096, 14336, 512, 1024, 512),
                                (1000, 300, 777, 128, 256, 128)]:
        for m_rows, n_cols in [(1, 1), (4, 2), (16, 16)]:
            np.testing.assert_allclose(
                tpm.gemm_tops(th, M, K, N, bm, bk, bn, m_rows=m_rows,
                              n_cols=n_cols),
                rpm.gemm_tops(rh, M, K, N, bm, bk, bn, m_rows=m_rows,
                              n_cols=n_cols), rtol=1e-12)


def _records():
    """Port records and the reference's records with the same numbers, one
    for each branch of ``suggestion``."""
    cases = [  # arch, shape, flops, bytes, collective bytes
        ("qwen1.5-4b", "train_4k", 1e14, 1e9, 1e9),      # compute, useful
        ("qwen1.5-4b", "train_4k", 3e16, 1e9, 1e9),      # compute, wasteful
        ("olmoe-1b-7b", "decode_32k", 1e9, 1e12, 1e6),   # memory, decode
        ("zamba2-1.2b", "prefill_32k", 1e9, 1e12, 1e6),  # memory
        ("arctic-480b", "train_4k", 1e12, 1e9, 1e13),    # collective
    ]
    out = []
    for arch, shape, f, b, c in cases:
        kind = C.SHAPES[shape].kind
        common = {"arch": arch, "shape": shape, "mesh": "16x16",
                  "chips": 256, "kind": kind, "status": "ok"}
        port = {**common, "wall_s": 1.0,
                "memory": {"state_gib_per_device": 2.0},
                "cost": {"flops_per_device": f, "bytes_per_device": b,
                         "collective_bytes_per_device": c,
                         "by_collective": {"all_gather": c}}}
        ref = {**common, "compile_s": 1.0,
               "memory": {"peak_per_device_gib": 2.0},
               "hlo": {"flops_per_device": f, "bytes_per_device": b,
                       "collective_bytes_per_device": c,
                       "by_collective": {"all-gather": c}}}
        out.append((port, ref))
    return out


def _ref_wording(text: str) -> str:
    """A port suggestion in the reference's words (its kernels are
    Pallas)."""
    return text.replace("the balanced GEMM kernels",
                        "balanced Pallas GEMM").replace("(CUDA kernels)",
                                                        "(Pallas)")


@pytest.mark.parametrize("hw", ["tpu_v6e", "tpu_v5e"])
def test_enrich_suggestion_and_rows_match_reference(hw):
    ref_table = rreport.markdown_tables([r for _, r in _records()],
                                        hw=rhw.get_hw(hw))
    seen = set()
    for port, ref in _records():
        t = report.enrich(dict(port), hw=thw.get_hw(hw))["roofline"]
        r = rreport.enrich(dict(ref), hw=rhw.get_hw(hw))["roofline"]
        assert t.keys() == r.keys() and t["dominant"] == r["dominant"]
        for k in t:
            if k not in ("hw", "dominant"):
                np.testing.assert_allclose(t[k], r[k], rtol=1e-12, err_msg=k)
        enriched = report.enrich(dict(port), hw=thw.get_hw(hw))
        s = report.suggestion(enriched)
        assert _ref_wording(s) == rreport.suggestion(
            rreport.enrich(dict(ref), hw=rhw.get_hw(hw)))
        seen.add(s)
        if port["arch"] != "qwen1.5-4b" or port["cost"]["flops_per_device"] \
                == 1e14:  # the table keeps one row per (arch, shape)
            assert _ref_wording(report.roofline_row(enriched)) in ref_table
    assert seen == set(report.SUGGESTIONS.values())
    md = report.markdown_tables([p for p, _ in _records()],
                                hw=thw.get_hw(hw))
    assert "### Roofline terms" in md and "| qwen1.5-4b | train_4k |" in md


def test_one_meta_cell_and_the_cli(tmp_path):
    with use_context(plan_cache=PlanCache()):  # not the default's cache
        rec = dryrun.run_cell("qwen1.5-4b", "train_4k", False,
                              str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["wall_s"] < 60
    cost = rec["cost"]
    assert cost["bytes_scope"] == "gemm"
    assert cost["flops_per_device"] == cost["gemm_flops_per_device"] + \
        cost["other_flops_per_device"] > 0
    assert cost["collective_bytes_per_device"] == sum(
        cost["by_collective"].values()) > 0
    assert rec["local_batch"] == 256 // 16
    # the step's FLOPs: at least the forward and backward's 6 N D of a
    # rank's tokens over the 16 ranks of 'model', which split each layer's
    # products (tensor parallelism; the recompute and attention come on
    # top)
    n = report._param_counts(C.get_config("qwen1.5-4b"))[1]
    assert cost["flops_per_device"] > 6 * n * rec["local_batch"] * 4096 / 16
    assert dryrun.main(["--arch", "qwen1.5-4b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path))
    assert files == ["qwen1.5-4b__decode_32k__single.json",
                     "qwen1.5-4b__train_4k__single.json"]
    with open(tmp_path / files[0]) as f:
        # the decode step over the mesh: tensor-parallel over 'model'
        assert json.load(f)["cost"]["collective_bytes_per_device"] > 0
    out = tmp_path / "report.md"
    report.main(["--dryrun-dir", str(tmp_path), "--out", str(out),
                 "--hw", "h100"])
    text = out.read_text()
    assert "| qwen1.5-4b | train_4k | 16x16 |" in text
    assert "| qwen1.5-4b | decode_32k |" in text and "h100" in text


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_cells_count_all_to_all_and_no_expert_gather(arch, tmp_path):
    """Expert parallelism in the dry run: the MoE decode cell on the 16 x
    16 mesh runs to ``ok`` with all-to-alls counted (``all-to-all`` in
    the reference's names), the train step too (cut to 2 layers here, at
    full width: the per-layer collectives are the full depth's), and a
    layer's expert tables are this rank's blocks with nothing gathered for
    them (the router alone gathered)."""
    from repro_torch import models
    from repro_torch.core.distributed import CollectiveCounter
    from repro_torch.interop import tree_items, tree_map_with_path
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.fsdp import ShardPlan

    with use_context(plan_cache=PlanCache()):
        rec = dryrun.run_cell(arch, "decode_32k", False, str(tmp_path))
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["cost"]["by_collective"]["all_to_all"] > 0
        assert report.by_collective(rec)["all-to-all"] == \
            rec["cost"]["by_collective"]["all_to_all"]
        cfg = dataclasses.replace(C.get_config(arch), n_layers=2)
        mesh = make_production_mesh()
        train = dryrun.train_cell(cfg, mesh, 256, 4096)
    assert train["cost"]["by_collective"]["all_to_all"] > 0
    params = models.init(cfg, device="meta")
    specs = shd.param_specs(models.axes(cfg), params, mesh)
    plan = ShardPlan(mesh, specs)
    blocks = shd.shard_tree(params, specs, mesh)
    layer = tree_map_with_path(lambda p, t: t[0], blocks["layers"])
    with CollectiveCounter() as c:
        got = plan.layer({"moe": layer["moe"]}, "layers")
    # the router alone is gathered (its block over 'data')
    router = layer["moe"].w_router
    assert c.by_kind() == {"all_gather": router.numel() *
                           router.element_size()}
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for path, t in tree_items(got["moe"]):
        if path != "w_router":
            assert t.shape[0] == E // 16 and t.numel() == E * d * f // 256


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_families_decode_cells_are_counted(arch, tmp_path):
    """The rwkv and hybrid decode cells on the 16 x 16 mesh run to ``ok``
    (their serve steps tensor-parallel over 'model', the decode states
    read and written as their blocks), with all-reduces over 'model'
    counted; zamba2's prefill_32k and train_4k cells run to ``ok`` too
    (its SSM scan in chunks of 64 tokens, groups of 16)."""
    with use_context(plan_cache=PlanCache()):
        rec = dryrun.run_cell(arch, "decode_32k", False, str(tmp_path))
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["cost"]["by_collective"]["all_reduce"] > 0
        assert rec["memory"]["decode_state_bytes_per_device"] > 0
        if arch == "zamba2-1.2b":
            for shape in ("prefill_32k", "train_4k"):
                cell = dryrun.run_cell(arch, shape, False, str(tmp_path))
                assert cell["status"] == "ok", (shape, cell.get("trace"))
                assert cell["cost"]["flops_per_device"] > 0
