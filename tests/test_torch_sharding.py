"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
and its 2-D and 3-D lane meshes (``repro_torch.launch.mesh``) against
``repro.distributed.sharding`` and ``repro.launch.mesh``.

No device is needed: the reference's specs come from
``repro.launch.inputs._resolve_guarded`` and
``repro.distributed.sharding.logical_axes_for_path`` over
``jax.eval_shape(model.init, PRNGKey(0))`` with a stand-in mesh (its
``axis_names`` and ``shape`` are all the rules read), the port's from
``param_pspecs`` on a ``meta`` model under a ``meta`` lane mesh.  Specs
are compared exactly: the port's per-period leaf must carry the
reference's spec for the stacked leaf with the leading (period) entry
dropped, and that entry must be ``None``.
"""
import math
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config as jget
from repro.distributed import sharding as jsh
from repro.launch.inputs import _resolve_guarded
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.convert import _by_reference_path
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _meta_mesh(shape, axes):
    lanes = [tmesh.Lane(torch.device("meta"), None)] * math.prod(shape)
    return tmesh.LaneMesh(lanes, shape, axes)


def test_rule_tables_are_the_references():
    assert sh.LOGICAL_TO_PHYSICAL == jsh.LOGICAL_TO_PHYSICAL
    assert sh.PARAM_RULES == jsh.PARAM_RULES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_equal_the_references(arch):
    structs = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(structs)[0]
    params = build_model(get_config(arch), device="meta").params()
    for shape, axes in MESHES:
        stand = _stand_in(shape, axes)
        ref = {jsh._path_str(p): tuple(_resolve_guarded(
            stand, jsh.logical_axes_for_path(jsh._path_str(p), x.ndim),
            x.shape)) for p, x in leaves}
        with sh.use_mesh(_meta_mesh(shape, axes)):
            specs = sh.param_pspecs(params)
        got = _by_reference_path(specs)
        assert set(ref) == {"/".join(map(str, p)) for p in got}
        n = 0
        for rpath, items in got.items():
            want = ref["/".join(map(str, rpath))]
            for period, spec in items:
                assert isinstance(spec, sh.PartitionSpec)
                if period is not None:
                    assert want[0] is None
                    assert tuple(spec) == want[1:], (rpath, spec, want)
                else:
                    assert tuple(spec) == want, (rpath, spec, want)
                n += 1
        assert n == len(list(torch.nn.Module.parameters(
            build_model(get_config(arch), device="meta"))))


def test_resolve_and_axis_size_follow_the_reference():
    stand = _stand_in((4, 2), ("data", "model"))
    mesh = _meta_mesh((4, 2), ("data", "model"))
    assert sh.resolve("batch", "model") == sh.P(None, None)   # off-mesh
    assert sh.axis_size("model") == 1
    cases = [(("batch", None), (8, 3)), (("fsdp", "model"), (8, 6)),
             (("fsdp", "model"), (6, 3)), (("model", "fsdp"), (2, 4)),
             (("expert", "seq", "ctx"), (4, 5, 6)), ((None,), (7,))]
    for shape, axes in (((4, 2), ("data", "model")),
                        ((2, 4, 2), ("pod", "data", "model"))):
        jmesh = types.SimpleNamespace(axis_names=axes,
                                      shape=dict(zip(axes, shape)))
        with sh.use_mesh(_meta_mesh(shape, axes)):
            for names, dims in cases:
                got = sh.resolve(*names, shape=dims)
                assert tuple(got) == tuple(_resolve_guarded(jmesh, names,
                                                            dims)), names
                assert tuple(sh.resolve(*names)) == tuple(
                    _resolve_guarded(jmesh, names, [0] * len(names)))
            for name in ("batch", "fsdp", "model", "expert", "seq", "ctx"):
                phys = jsh.LOGICAL_TO_PHYSICAL[name]
                want = 1 if phys is None else math.prod(
                    jmesh.shape[a] for a in (phys if isinstance(phys, tuple)
                                             else (phys,))
                    if a in axes)
                assert sh.axis_size(name) == want, name
    with sh.use_mesh(mesh):
        # the guard: 2 kv heads never shard over a 4-way axis; 6 rows do
        # not split over 'data' (4)
        assert sh.resolve("fsdp", "model", shape=(6, 3)) == sh.P(None, None)
        assert sh.resolve("fsdp", "model", shape=(8, 6)) == sh.P("data",
                                                                 "model")
        assert sh.resolve("batch", shape=(8,)) == sh.P("data")
        assert sh.P(("data",), (), ("pod", "data")) == \
            ("data", None, ("pod", "data"))
        assert tuple(sh.resolve("batch", shape=(8,))) == tuple(
            _resolve_guarded(stand, ("batch",), (8,)))
        x = torch.ones(3)
        assert sh.constrain(x, "batch") is x
    assert sh._current_mesh() is None


def test_dev_and_production_meshes(monkeypatch):
    monkeypatch.delenv(tmesh.FORCE_LANES_ENV, raising=False)
    with pytest.raises(RuntimeError, match=tmesh.FORCE_LANES_ENV):
        tmesh.make_dev_mesh((2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="need 256 lanes"):
        tmesh.make_production_mesh(device="cpu")
    one = tmesh.make_dev_mesh((1, 1), device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        m = tmesh.make_production_mesh(multi_pod=multi, device="meta")
        assert m.axis_names == axes and m.devices_shape == shape
        assert m.shape == dict(zip(axes, shape))
        assert len(m) == math.prod(shape)
        assert all(lane.device.type == "meta" and lane.stream is None
                   for lane in m)
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")
    m = tmesh.make_dev_mesh((4, 2), ("data", "model"), device="cpu")
    assert m.shape == {"data": 4, "model": 2} and len(m) == 8
    assert all(lane.device.type == "cpu" for lane in m)
    assert m.coords(5) == {"data": 2, "model": 1} and m.index(m.coords(5)) == 5
    assert len(m.group_lanes(("data",))) == 4
    assert len(m.group_lanes(("model",))) == 2
    assert [m.group_index(m.coords(i), ("data",)) for i in range(8)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(RuntimeError, match="need 9 lanes"):
        tmesh.make_dev_mesh((3, 3), device="cpu")
    with pytest.raises(ValueError, match="repeat"):
        tmesh.LaneMesh(list(m), (4, 2), ("data", "data"))


def test_shard_and_gather_are_device_put_and_back(monkeypatch):
    """A spec's shards are the slices ``jax.device_put`` gives each device
    of a ``(4, 2)`` mesh (row-major device order), copies where the spec
    replicates; gathering them gives the tensor back."""
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")
    mesh = tmesh.make_dev_mesh((4, 2), device="cpu")
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    for spec, want_shape in ((sh.P("data", "model"), (4, 4)),
                             (sh.P("model", None), (8, 8)),
                             (sh.P(None, "data"), (16, 2)),
                             (sh.P(("data", "model"), None), (2, 8)),
                             (sh.P(), (16, 8))):
        s = sh.shard(x, mesh, spec)
        assert len(s.shards) == 8
        for i, t in enumerate(s.shards):
            assert tuple(t.shape) == want_shape
            c = mesh.coords(i)
            sl = sh.shard_slices(x.shape, mesh, spec, i)
            assert torch.equal(t, x[sl])
            assert s.lane_bytes(i) == t.numel() * 4
            if spec == sh.P("data", "model"):
                assert torch.equal(t, x[4 * c["data"]:4 * c["data"] + 4,
                                        4 * c["model"]:4 * c["model"] + 4])
        assert torch.equal(sh.gather(s), x)
        assert s.shards[0].data_ptr() != s.shards[1].data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        sh.shard(torch.zeros(6, 8), mesh, sh.P("data", None))
    np.testing.assert_array_equal(
        sh.gather(sh.shard(x, mesh, sh.P("data", "model"))).numpy(),
        x.numpy())


def test_gather_puts_several_ranges_side_by_side(monkeypatch):
    """A region entry that is a tuple of slices (a Mamba2 lane's columns
    of ``in_proj``: ranges that cut the shards anywhere, one shard serving
    several) gives the ranges laid side by side, in ``dtype``, on the
    lane's device; the plan reads each shard's parts where they lie."""
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")
    mesh = tmesh.make_dev_mesh((4, 2), device="cpu")
    x = torch.arange(16 * 14, dtype=torch.float32).reshape(16, 14) / 7
    s = sh.shard(x, mesh, sh.P("data", "model"))
    cols = ((2, 5), (6, 9), (10, 11))
    region = (slice(0, 16), tuple(slice(*c) for c in cols))
    got = sh.gather(s, lane=3, region=region, dtype=torch.bfloat16)
    want = torch.cat([x[:, a:b] for a, b in cols], dim=1)
    assert sh.region_shape(region) == (16, 7)
    assert got.dtype == torch.bfloat16 and torch.equal(got,
                                                       want.bfloat16())
    plan = sh.gather_plan(s, region)
    # columns 6:9 cross the model shards' boundary at 7: two parts
    assert len(plan) == 4 * 4 and len({i for i, _, _ in plan}) == 8
    for i, at, part in plan:
        assert torch.equal(got[at], s.shards[i][part].bfloat16())
