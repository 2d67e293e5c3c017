"""Kronecker-sum operator: structure-exploiting SpMV."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps

from poms_tpu.core.vector import StencilVector
from poms_tpu.mg.cycles import CycleConfig
from poms_tpu.mg.hierarchy import _kron_operator_from_1d
from poms_tpu.mg.smoother import SmootherConfig
from poms_tpu.mg.solver import MultigridSolver
from poms_tpu.models.poisson import poisson_problem


def _kron_op(prob):
    return _kron_operator_from_1d([(s.K, s.M) for s in prob.splines],
                                  prob.space)


def _band_csr(B, pad, periodic):
    """scipy CSR of a 1D band: row i holds B[i, t] at column i + t − pad."""
    n = B.shape[0]
    rows, cols, vals = [], [], []
    for t in range(2 * pad + 1):
        j = np.arange(n) + t - pad
        keep = np.ones(n, bool) if periodic else (j >= 0) & (j < n)
        rows.append(np.arange(n)[keep])
        cols.append((j % n)[keep])
        vals.append(B[keep, t])
    return sps.csr_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n))


def _kron_oracle(op, x):
    """Σ_r ⊗_a B_r^(a) · x, one CSR product per axis."""
    sp = op.space
    out = np.zeros(x.shape)
    for term in op.terms:
        y = x
        for a, B in enumerate(term):
            M = _band_csr(np.asarray(B, np.float64), sp.pads[a],
                          sp.periodic[a])
            ya = np.moveaxis(y, a, 0)
            ya = (M @ ya.reshape(ya.shape[0], -1)).reshape(ya.shape)
            y = np.moveaxis(ya, 0, a)
        out += y
    return out


def _random_kron(npts, p, periodic, seed=0):
    from poms_tpu.core.kron import KroneckerSumOperator
    from poms_tpu.core.space import StencilVectorSpace

    d = len(npts)
    rng = np.random.default_rng(seed)
    sp = StencilVectorSpace(npts=npts, pads=(p,) * d,
                            periodic=(periodic,) * d)
    Ks = [jnp.asarray(rng.standard_normal((n, 2 * p + 1))) for n in npts]
    Ms = [jnp.asarray(rng.standard_normal((n, 2 * p + 1))) for n in npts]
    return KroneckerSumOperator(sp, [[Ks[b] if b == a else Ms[b]
                                      for b in range(d)] for a in range(d)])


@pytest.mark.parametrize("dim,n_el,p,periodic", [
    pytest.param(1, 12, 2, None, id="1-12-2"),
    pytest.param(2, (8, 10), 3, None, id="2-n_el1-3"),
    pytest.param(3, 6, 2, None, id="3-6-2"),
    # random 1D bands against per-axis CSR products: ragged extents on
    # every axis, lane widths past powers of two, and periodic wrap
    pytest.param(3, (8, 12, 130), 2, False, id="random-8x12x130-p2"),
    pytest.param(3, (10, 130, 140), 3, False, id="random-10x130x140-p3"),
    pytest.param(3, (8, 8, 128), 2, True, id="random-8x8x128-p2-periodic"),
    pytest.param(3, (6, 64, 96), 1, False, id="random-6x64x96-p1"),
])
def test_kron_dot_matches_banded(dim, n_el, p, periodic):
    rng = np.random.default_rng(0)
    if periodic is not None:
        K = _random_kron(n_el, p, periodic)
        x = rng.standard_normal(n_el)
        y_k = K.dot(StencilVector.from_interior(K.space, x))
        np.testing.assert_allclose(np.asarray(y_k.interior),
                                   _kron_oracle(K, x), rtol=1e-12,
                                   atol=1e-12)
        return
    prob = poisson_problem(dim, n_el, degree=p)
    K = _kron_op(prob)
    x = StencilVector.from_interior(prob.space,
                                    rng.standard_normal(prob.space.npts))
    y_k = K.dot(x)
    y_b = prob.A.dot(x)
    np.testing.assert_allclose(np.asarray(y_k.interior),
                               np.asarray(y_b.interior), rtol=1e-12,
                               atol=1e-12)


def test_kron_diagonal_and_to_stencil():
    prob = poisson_problem(2, (6, 8), degree=2)
    K = _kron_op(prob)
    np.testing.assert_allclose(np.asarray(K.diagonal()),
                               np.asarray(prob.A.diagonal()), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(K.to_stencil().band),
                               np.asarray(prob.A.band), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(K.toarray(), prob.A.toarray(), atol=1e-12)


def test_kron_transpose():
    prob = poisson_problem(2, (6, 8), degree=2)
    K = _kron_op(prob)
    np.testing.assert_allclose(K.T.toarray(), prob.A.toarray().T, atol=1e-12)


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_kron_solver_matches_banded(smoother):
    prob = poisson_problem(2, 32, degree=3)
    cfg = CycleConfig(smoother=SmootherConfig(smoother, 0.8))
    mg_b = MultigridSolver(prob, num_levels=3, cfg=cfg, operator="banded")
    mg_k = MultigridSolver(prob, num_levels=3, cfg=cfg, operator="kron")
    res_b = mg_b.solve(tol=1e-10, maxiter=60)
    res_k = mg_k.solve(tol=1e-10, maxiter=60)
    assert res_k.converged and res_k.iterations == res_b.iterations
    np.testing.assert_allclose(res_k.residuals, res_b.residuals,
                               rtol=1e-6, atol=1e-13)


def test_kron_3d_solver():
    prob = poisson_problem(3, 8, degree=2)
    cfg = CycleConfig(smoother=SmootherConfig("jacobi", 0.7))
    mg = MultigridSolver(prob, num_levels=2, cfg=cfg, operator="kron")
    res = mg.solve(tol=1e-9, maxiter=60)
    assert res.converged
