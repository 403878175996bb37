"""The port's sparse-projection kernel K4: its plain version
(``repro_torch.kernels.ref.sparse_project_ref``) and wrapper
(``kernels.ops.sparse_project``) against the reference's oracle
(``repro.kernels.ref.sparse_project_ref``) and its Pallas kernel in
interpret mode (``repro.kernels.project.sparse_project_pallas``, through
``repro.kernels.ops.sparse_project(impl='pallas')``), on the same seeded
numpy packs and batches: the shapes of the reference's own projector test,
B = 1, overlapping supports and a component that is all padding.

Tolerance rtol 1e-5, atol 1e-5, the bar of the reference's own
``tests/test_serve.py``: float32 sums of up to ``cap`` terms in another
order.  Inputs are finite (a non-finite X[:, 0] is where the reference's
plain version, which multiplies padded slots by X[:, 0], parts from its
kernel, which skips them).  The kernel itself runs only on a card:
``tests/test_torch_package.py`` holds it to the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spca import PCResult as JPCResult
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import pack_components as jpack
from repro_torch.core.spca import PCResult
from repro_torch.kernels import ops, project
from repro_torch.kernels import ref as tref
from repro_torch.obs import metrics
from repro_torch.serve import pack_components

TOL = dict(rtol=1e-5, atol=1e-5)


def _components(n, k, card, seed, cls=PCResult, overlap=0):
    """k unit components of cardinality ``card`` over n words; the first
    ``overlap`` words of every support are shared."""
    rng = np.random.default_rng(seed)
    used = rng.permutation(n)
    shared, rest = used[:overlap], used[overlap:]
    out = []
    for c in range(k):
        own = rest[c * (card - overlap):(c + 1) * (card - overlap)]
        sup = np.sort(np.concatenate([shared, own]))
        x = np.zeros(n)
        x[sup] = rng.normal(size=card)
        x /= np.linalg.norm(x)
        out.append(cls(x=x, support=sup, lam=1.0 + 0.1 * c, variance=1.0,
                       cardinality=card, reduced_n=card, gap=0.0))
    return out


def _pack(n, k, card, seed, overlap=0):
    """The port's and the reference's packs of the same components;
    they must agree."""
    tp = pack_components(_components(n, k, card, seed, overlap=overlap),
                         n_features=n)
    jp = jpack(_components(n, k, card, seed, cls=JPCResult, overlap=overlap),
               n_features=n)
    np.testing.assert_array_equal(tp.support_idx, jp.support_idx)
    np.testing.assert_array_equal(tp.values, jp.values)
    assert tp.support_idx.dtype == jp.support_idx.dtype == np.int32
    assert tp.values.dtype == jp.values.dtype == np.float32
    return tp


def _both(X, sidx, vals):
    """(port plain version, reference oracle, reference Pallas interpret)."""
    port = ops.sparse_project(torch.from_numpy(X), torch.from_numpy(sidx),
                              torch.from_numpy(vals))
    jX, js, jv = jnp.asarray(X), jnp.asarray(sidx), jnp.asarray(vals)
    oracle = np.asarray(jref.sparse_project_ref(jX, js, jv))
    pallas = np.asarray(jops.sparse_project(jX, js, jv, impl="pallas"))
    return port.numpy(), oracle, pallas


CASES = [(16, 200, 3, 5, 0), (100, 1000, 5, 7, 0), (8, 300, 1, 3, 0),
         (130, 513, 4, 9, 0), (1, 400, 5, 5, 0), (1, 64, 1, 1, 0),
         (12, 100, 3, 4, 2)]


@pytest.mark.parametrize("B,n,k,card,overlap", CASES)
def test_plain_version_matches_reference_oracle_and_pallas(B, n, k, card,
                                                            overlap):
    pack = _pack(n, k, card, seed=n + k, overlap=overlap)
    rng = np.random.default_rng(B * n)
    X = rng.poisson(0.5, size=(B, n)).astype(np.float32)
    if overlap:
        X[:, pack.support_idx[0, :overlap]] += 3.0   # shared words matter
    port, oracle, pallas = _both(X, pack.support_idx, pack.values)
    assert port.shape == (B, k) and port.dtype == np.float32
    np.testing.assert_allclose(port, oracle, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)
    # dense ground truth: loadings scattered into W (n, k), X @ W
    W = np.zeros((n, k), np.float32)
    for c in range(k):
        W[pack.support_idx[c], c] += pack.values[c]
    np.testing.assert_allclose(port, X @ W, **TOL)


def test_all_padding_component_scores_zero():
    """A component whose slots are all padding (index 0, value 0) scores
    exactly 0; the others are untouched."""
    pack = _pack(300, 4, 6, seed=3)
    sidx, vals = pack.support_idx.copy(), pack.values.copy()
    sidx[2], vals[2] = 0, 0.0
    X = np.random.default_rng(1).poisson(0.7, size=(33, 300)).astype(
        np.float32)
    X[:, 0] = 5.0                 # padded slots point at a busy column
    port, oracle, pallas = _both(X, sidx, vals)
    np.testing.assert_array_equal(port[:, 2], np.zeros(33, np.float32))
    np.testing.assert_allclose(port, oracle, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)


def test_plain_version_reduces_in_slot_order():
    """The plain version's per-slot multiply-then-add in slot order (the
    kernel's order) gives the sequential float32 sum bit for bit."""
    pack = _pack(500, 3, 7, seed=9)
    X = np.random.default_rng(2).normal(size=(20, 500)).astype(np.float32)
    got = tref.sparse_project_ref(torch.from_numpy(X),
                                  torch.from_numpy(pack.support_idx),
                                  torch.from_numpy(pack.values)).numpy()
    want = np.zeros((20, 3), np.float32)
    for j in range(pack.cap):
        want = want + (X[:, pack.support_idx[:, j]] * pack.values[:, j])
    np.testing.assert_array_equal(got, want)


def test_wrapper_counts_dispatches_and_refuses_what_k4_does_not_take():
    pack = _pack(120, 2, 4, seed=0)
    X = torch.ones((4, 120))
    sidx = torch.from_numpy(pack.support_idx)
    vals = torch.from_numpy(pack.values)
    project.reset_launches()
    with metrics.use_registry() as reg:
        ops.sparse_project(X, sidx, vals)
        ops.sparse_project(X, sidx, vals, impl="ref")
        assert reg.value("kernel.launches.sparse_project") == 2
    assert project.launches == 0          # the CPU never launches K4
    with pytest.raises(ValueError, match="CUDA"):
        ops.sparse_project(X, sidx, vals, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.sparse_project(X, sidx, vals, impl="pallas")
    with pytest.raises(TypeError, match="float32"):
        ops.sparse_project(X.double(), sidx, vals)
    with pytest.raises(TypeError, match="int32"):
        ops.sparse_project(X, sidx.long(), vals)
    with pytest.raises(ValueError, match="shape"):
        ops.sparse_project(X, sidx, vals[:, :2])
    with pytest.raises(TypeError, match="tensor"):
        ops.sparse_project(X.numpy(), sidx, vals)
    with pytest.raises(ValueError, match="CUDA"):
        project.sparse_project_cuda(X, sidx, vals)
