"""The port's logical-axis sharding against the reference's, entry for
entry, on the CPU (no process group: specs read only a mesh's shape).

* ``models.axes`` and ``quant.prequant.quantize_axes`` trees for every
  arch, leaf for leaf;
* ``param_specs`` for every arch, and ``decode_state_specs`` for every
  arch's decode state (static, per-slot, paged with bf16 and int8 pools,
  and the long-context batch of 1), on the reference's fake 16 x 16 and
  2 x 16 x 16 meshes (``tests/test_data_sharding.py``);
* ``spec_for``'s rules, ``batch_specs`` and ``attention._attn_mode``;
* the reference's hypothesis property: any (axes, shape) gives a spec with
  unique mesh axes, each on a dim its extent divides;
* the per-rank layout: ``local_shape``, ``shard_leaf`` and ``gather_leaf``
  on an abstract mesh, and ``interop.shard_state``.

Specs are compared exactly: both are tuples of entries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro import configs as RC
from repro import models as rmodels
from repro.core.context import use_context as r_use_context
from repro.layers import attention as rattn
from repro.layers.common import set_activation_mesh
from repro.models.lm import is_axes_leaf as r_is_axes_leaf
from repro.parallel import sharding as rshd
from repro.quant.prequant import quantize_axes as r_quantize_axes
from repro_torch import configs as C
from repro_torch import interop, models
from repro_torch.core.context import use_context
from repro_torch.interop import tree_items
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.layers import attention as tattn
from repro_torch.parallel import sharding as shd
from repro_torch.quant.prequant import quantize_axes

ARCHS = C.list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_mesh(shape, names):
    """The reference test's abstract mesh stand-in (no devices needed)."""
    class FakeMesh:
        axis_names = names

        class devices:
            pass
    m = FakeMesh()
    m.devices = type("D", (), {"shape": shape})()
    return m


def _meshes(name):
    shape, names = MESHES[name]
    return _fake_mesh(shape, names), Mesh(names, shape)


def _ref_key(entry) -> str:
    return str(getattr(entry, "key", getattr(entry, "name", "")))


def _ref_flat(tree, is_leaf) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_ref_key(e) for e in path): leaf for path, leaf in leaves}


def _ref_specs(tree) -> dict:
    return {k: tuple(v) for k, v in _ref_flat(
        tree, lambda x: isinstance(x, jax.sharding.PartitionSpec)).items()}


def _port_specs(tree) -> dict:
    return {k: tuple(v) for k, v in tree_items(tree)}


def _ref_params(arch):
    cfg = RC.get_config(arch)
    return cfg, jax.eval_shape(lambda: rmodels.init(jax.random.PRNGKey(0),
                                                    cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_match_reference(arch):
    ref = _ref_flat(rmodels.axes(RC.get_config(arch)), r_is_axes_leaf)
    got = dict(tree_items(models.axes(C.get_config(arch))))
    assert got == ref
    qref = _ref_flat(r_quantize_axes(rmodels.axes(RC.get_config(arch))),
                     r_is_axes_leaf)
    assert dict(tree_items(quantize_axes(models.axes(C.get_config(arch))))) \
        == qref


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    fake, port = _meshes(mesh)
    rcfg, rshapes = _ref_params(arch)
    ref = _ref_specs(rshd.param_specs(rmodels.axes(rcfg), rshapes, fake))
    cfg = C.get_config(arch)
    got = _port_specs(shd.param_specs(models.axes(cfg),
                                      models.init(cfg, device="meta"), port))
    assert got == ref
    assert any(any(e is not None for e in s) for s in got.values())


def _decode_states(arch):
    """(name, reference kwargs) of every decode state the arch has."""
    cfg = C.get_config(arch)
    out = [("static", dict(batch=128, max_len=4096)),
           ("long", dict(batch=1, max_len=524288))]
    if cfg.family in ("dense", "moe"):
        out += [("per_slot", dict(batch=32, max_len=2048, per_slot=True)),
                ("paged", dict(batch=32, max_len=2048, per_slot=True,
                               kv_block_size=16, num_kv_blocks=4097)),
                ("paged_int8", dict(batch=32, max_len=2048, per_slot=True,
                                    kv_block_size=16, num_kv_blocks=4096,
                                    kv_dtype="int8"))]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_reference(arch, mesh):
    fake, port = _meshes(mesh)
    rcfg, cfg = RC.get_config(arch), C.get_config(arch)
    for name, kw in _decode_states(arch):
        b, s = kw.pop("batch"), kw.pop("max_len")
        paged = "kv_block_size" in kw
        rshapes = jax.eval_shape(
            lambda: rmodels.init_decode_state(rcfg, b, s, **kw))
        ref = _ref_specs(rshd.decode_state_specs(rshapes, rcfg, fake,
                                                 paged=paged))
        state = models.init_decode_state(cfg, b, s, device="meta", **kw)
        got = _port_specs(shd.decode_state_specs(state, cfg, port,
                                                 paged=paged))
        assert got == ref, name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_reference(mesh):
    fake, port = _meshes(mesh)
    for shapes in ({"tokens": (256, 4096), "labels": (256, 4096)},
                   {"tokens": (1, 128)}, {"tokens": (48, 7)},
                   {"tokens": (32, 16), "frames": (32, 1500, 512)},
                   {"scalar": ()}):
        ref = rshd.batch_specs({k: jax.ShapeDtypeStruct(s, jnp.int32)
                                for k, s in shapes.items()}, fake)
        got = shd.batch_specs({k: torch.empty(s, device="meta")
                               for k, s in shapes.items()}, port)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in ref.items()}


def test_spec_for_rules():
    """The reference test's cases: basic rules, first claim wins, the
    divisibility guard, trailing Nones trimmed."""
    m = make_production_mesh()
    assert shd.spec_for(("embed", "heads"), (4096, 4096), m) == \
        ("data", "model")
    assert shd.spec_for(("vocab", None), (128256, 4096), m) == ("model",)
    assert shd.spec_for(("expert", "embed", "ffn"), (64, 2048, 1024), m) \
        == ("data", None, "model")
    assert shd.spec_for(("ffn", "heads"), (1024, 2048), m) == ("model",)
    assert shd.spec_for(("heads",), (20,), m) == ()
    assert shd.spec_for(("heads",), (32,), m) == ("model",)
    assert shd.spec_for(None, (3, 4), m) == ()


@pytest.mark.parametrize("mesh", [None, "16x16", "2x16x16", "4x2"])
def test_attn_mode_matches_reference(mesh):
    if mesh == "4x2":
        fake, port = _fake_mesh((4, 2), ("data", "model")), \
            Mesh(("data", "model"), (4, 2))
    elif mesh is None:
        fake = port = None
    else:
        fake, port = _meshes(mesh)
    for n_heads in (1, 8, 16, 20, 32, 56, 64):
        for seq in (1, 16, 100, 4096):
            with r_use_context():  # a copy: the mesh set stays in it
                set_activation_mesh(fake)
                want = rattn._attn_mode(n_heads, seq)
            with use_context(mesh=port):
                assert tattn._attn_mode(n_heads, seq) == want


@settings(max_examples=30, deadline=None)
@given(
    d0=st.sampled_from([1, 8, 20, 64, 256]),
    d1=st.sampled_from([1, 16, 48, 512]),
    axes=st.sampled_from([("embed", "heads"), ("vocab", None),
                          ("ffn", "embed"), (None, None)]),
)
def test_property_spec_always_valid(d0, d1, axes):
    """Any (axes, shape): unique mesh axes, each on a dim it divides, and
    the reference's spec."""
    m = make_production_mesh()
    spec = shd.spec_for(axes, (d0, d1), m)
    used = [e for e in spec if e is not None]
    assert len(used) == len(set(used))
    for dim, e in zip((d0, d1), list(spec) + [None]):
        if e is not None:
            assert dim % 16 == 0
    assert tuple(spec) == tuple(rshd.spec_for(
        axes, (d0, d1), _fake_mesh((16, 16), ("data", "model"))))


def test_local_shape_shard_and_gather_on_an_abstract_mesh():
    """One rank's block of a leaf at each coordinate tiles the leaf; on an
    abstract mesh the gather gives back the whole shape (meta)."""
    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    spec = shd.P(None, ("pod", "data"), "model")
    shape = (2, 3, 2)
    blocks = {}
    for coords in np.ndindex(*shape):
        m = Mesh(("pod", "data", "model"), shape, tuple(coords))
        assert shd.local_shape(full.shape, spec, m) == (8, 1, 2)
        blocks[coords] = shd.shard_leaf(full, spec, m)
    for (p, d, mo), blk in blocks.items():
        torch.testing.assert_close(
            blk, full[:, p * 3 + d:p * 3 + d + 1, mo * 2:mo * 2 + 2],
            rtol=0, atol=0)
    m = Mesh(("pod", "data", "model"), shape)
    back = shd.gather_leaf(torch.empty((8, 1, 2), device="meta"), spec, m)
    assert back.shape == full.shape and back.device.type == "meta"
    assert shd.shard_leaf(full, shd.P(), m) is full


def test_shard_state_lays_a_tree_out_per_rank():
    cfg = C.smoke(C.get_config("qwen1.5-4b"))
    params = models.init(cfg, device="cpu")
    m = Mesh(("data", "model"), (2, 2), (1, 0))
    specs = shd.param_specs(models.axes(cfg), params, m)
    local = interop.shard_state(params, specs, m)
    sp = dict(tree_items(specs))
    for path, t in tree_items(local):
        full = dict(tree_items(params))[path]
        assert tuple(t.shape) == shd.local_shape(full.shape, sp[path], m)
        torch.testing.assert_close(t, shd.shard_leaf(full, sp[path], m),
                                   rtol=0, atol=0)
