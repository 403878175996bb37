"""The port's pooled statistics on a 2-D lane mesh and its compressed
mean (``repro_torch.core.distributed`` on a ``LaneMesh``,
``repro_torch.optim.compression.compressed_pmean``) against
``tests/test_distributed.py``'s cases and bars and against the reference.

- Dense passes on a ``(4, 2)`` ``("data", "model")`` mesh of CPU lanes:
  variances and Gram within the reference test's bars of numpy (1e-5
  relative, 1e-6 absolute), and equal bit for bit to a 4-lane
  ``DataMesh`` (the documents split over ``data`` only, in the same
  blocks, pooled in the same order).
- ``psum_partials(axes=("data",))`` on that mesh against the reference's
  host-side ``combine_screens`` of the same shards (1e-12 in float64).
- ``compressed_pmean`` on the reference test's ``(8, 1024)`` inputs (seed
  2) against the reference's ``shard_map`` version, run in a child
  interpreter with 8 forced XLA devices: residuals equal, means within
  1e-6, over two steps of error feedback; and the reference test's own
  bars: one step within 0.05 of the exact mean, 20 steps averaging to it
  within 5e-3.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import elimination as jelim
from repro_torch.core import distributed as tdist
from repro_torch.launch import mesh as tmesh
from repro_torch.optim.compression import compressed_pmean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def eight_lanes(monkeypatch):
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's compressed_pmean on 8 forced devices, two steps."""
    out = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import make_dev_mesh
        from repro.optim.compression import compressed_pmean
        mesh = make_dev_mesh((8,), ("data",))
        g = jnp.asarray(np.random.default_rng(2).normal(size=(8, 1024)),
                        jnp.float32)
        shard_map = getattr(jax, "shard_map", None)
        if shard_map is None:
            from jax.experimental.shard_map import shard_map
            kw = {{"check_rep": False}}
        else:
            kw = {{"check_vma": False}}
        sm = shard_map(lambda a, r: compressed_pmean(a, r, "data"),
                       mesh=mesh, in_specs=(P("data", None), P("data", None)),
                       out_specs=(P("data", None), P("data", None)), **kw)
        m1, r1 = sm(g, jnp.zeros((8, 1024), jnp.float32))
        m2, r2 = sm(g, r1)
        np.savez({out!r}, g=np.asarray(g), m1=np.asarray(m1),
                 r1=np.asarray(r1), m2=np.asarray(m2), r2=np.asarray(r2))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_dense_statistics_on_a_2d_mesh():
    mesh = tmesh.make_dev_mesh((4, 2), ("data", "model"), device="cpu")
    assert tdist.data_axes_of(mesh) == ("data",)
    data4 = tmesh.make_data_mesh(4, device="cpu")
    assert tdist.data_axes_of(data4) == ("data",)
    A = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 40))
                         .astype(np.float32))
    sc = tdist.distributed_variances(A, mesh)
    a = A.numpy().astype(np.float64)
    np.testing.assert_allclose(sc.variances.numpy(), a.var(0), rtol=1e-5,
                               atol=1e-6)
    assert sc.count == 64
    g = tdist.distributed_gram(A, mesh, means=sc.means)
    ac = a - a.mean(0)
    np.testing.assert_allclose(g.numpy(), ac.T @ ac / 64, rtol=1e-5,
                               atol=1e-6)
    sc4 = tdist.distributed_variances(A, data4)
    g4 = tdist.distributed_gram(A, data4, means=sc4.means)
    for x, y in ((sc.variances, sc4.variances), (sc.means, sc4.means),
                 (g, g4)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    S2, sup2, _ = tdist.distributed_screen_and_gram(A, mesh, lam=0.5)
    S4, sup4, _ = tdist.distributed_screen_and_gram(A, data4, lam=0.5)
    assert np.array_equal(sup2, sup4) and sup2.size > 0
    assert torch.equal(S2.view(torch.int32), S4.view(torch.int32))


def test_psum_partials_over_the_data_axis():
    """Pooling over ``data`` of a (4, 2) mesh equals the reference's
    host-side `combine_screens` of the same four shards."""
    mesh = tmesh.make_dev_mesh((4, 2), ("data", "model"), device="cpu")
    rng = np.random.default_rng(7)
    A = rng.normal(size=(4, 16, 40))
    s, ss, cnt = tdist.psum_partials((
        torch.from_numpy(A.sum(axis=1)),
        [torch.from_numpy((a * a).sum(0)) for a in A],
        np.full((4, 1), 16.0)), mesh, axes=("data",))
    assert float(cnt[0]) == 64
    mean = s / cnt
    var = ss / cnt - mean * mean
    want = jelim.combine_screens([jelim.feature_variances(jnp.asarray(a))
                                  for a in A])
    np.testing.assert_allclose(mean.numpy(), np.asarray(want.means),
                               atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(want.variances),
                               atol=1e-12)
    # the default axes are the data axes; 'model' pools 2 partials
    s_default, = tdist.psum_partials((torch.from_numpy(A.sum(axis=1)),), mesh)
    assert torch.equal(s_default, s)
    m2, = tdist.psum_partials(([torch.ones(3), torch.ones(3)],), mesh,
                              axes=("model",))
    assert torch.equal(m2, torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="4 partials for 2 lanes"):
        tdist.psum_partials(([torch.zeros(2)] * 4,), mesh, axes=("model",))
    with pytest.raises(ValueError, match="one axis 'data'"):
        tdist.psum_partials(([torch.zeros(2)] * 4,),
                            tmesh.make_data_mesh(4, device="cpu"),
                            axes=("model",))


def _pmean(g, res):
    mesh = tmesh.make_data_mesh(8, device="cpu")
    means, new_res = compressed_pmean(torch.from_numpy(g),
                                      torch.from_numpy(res), mesh)
    assert all(torch.equal(m, means[0]) for m in means)
    return means[0].numpy(), torch.stack(new_res).numpy()


def test_compressed_pmean_matches_the_reference(reference):
    g = reference["g"]
    m1, r1 = _pmean(g, np.zeros_like(g))
    np.testing.assert_array_equal(r1, reference["r1"])
    np.testing.assert_allclose(m1, reference["m1"][0], rtol=0, atol=1e-6)
    m2, r2 = _pmean(g, r1)
    np.testing.assert_array_equal(r2, reference["r2"])
    np.testing.assert_allclose(m2, reference["m2"][0], rtol=0, atol=1e-6)
    assert m1.dtype == np.float32 and np.abs(r1).max() > 0


def test_compressed_pmean_error_feedback(reference):
    """The reference test's bars (tests/test_distributed.py:123-158)."""
    g = reference["g"]
    exact = g.mean(0)
    m1, _ = _pmean(g, np.zeros_like(g))
    assert np.abs(m1 - exact).max() < 0.05
    total = np.zeros_like(exact)
    res = np.zeros_like(g)
    for _ in range(20):
        m, res = _pmean(g, res)
        total += m
    np.testing.assert_allclose(total / 20, exact, atol=5e-3)
    with pytest.raises(ValueError, match="8 tensors for 7 residuals"):
        compressed_pmean(list(torch.from_numpy(g)),
                         list(torch.zeros(7, 1024)))
