"""Container + SpMV tests against the scipy oracle (SURVEY.md §4 tier 1).

The reference's dominant test style [recall:med]: build a stencil matrix with
random band data, convert with tocsr/toarray, assert banded dot ≡ CSR dot.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from poms_tpu.core.matrix import StencilMatrix
from poms_tpu.core.space import StencilVectorSpace
from poms_tpu.core.vector import StencilVector


def random_stencil(npts, pads, periodic=False, seed=0):
    """Random banded operator with boundary-legal rows (non-periodic)."""
    rng = np.random.default_rng(seed)
    space = StencilVectorSpace(npts=npts, pads=pads, periodic=periodic)
    band = rng.standard_normal(space.npts + space.band_shape)
    # zero out entries reaching outside the domain in non-periodic dims
    for a, (n, p, per) in enumerate(zip(space.npts, space.pads, space.periodic)):
        if per:
            continue
        i = np.arange(n).reshape([-1 if b == a else 1 for b in range(space.ndim)]
                                 + [1] * space.ndim)
        off = np.arange(2 * p + 1).reshape(
            [1] * space.ndim + [-1 if b == a else 1 for b in range(space.ndim)])
        col = i + off - p
        band = np.where((col < 0) | (col >= n), 0.0, band)
    A = StencilMatrix.from_band(space, band)
    return space, A


CASES = [
    ((13,), (2,), (False,)),
    ((16,), (3,), (True,)),
    ((9, 11), (2, 1), (False, False)),
    ((8, 8), (2, 2), (True, False)),
    ((6, 7, 8), (1, 2, 1), (False, False, False)),
    ((6, 6, 6), (2, 2, 2), (True, True, True)),
]


def _dirichlet(npts, p):
    return (npts, (p,) * len(npts), (False,) * len(npts))


# Shapes that stress the shifted-MAC apply: ragged 1D/2D/3D extents, lane
# widths just past powers of two, odd middle extents and p = 3 on tiny
# grids, where most stencil reads fall in the ghost layer.
KERNEL_CASES = [_dirichlet(n, p) for n, p in [
    ((32,), 3), ((600,), 2), ((513,), 1),
    ((16, 24), 2), ((40, 140), 3),
    ((8, 12, 20), 1), ((10, 9, 130), 2),
    ((6, 8, 10), 1), ((6, 9, 10), 1), ((6, 7, 10), 2), ((8, 17, 10), 3),
    ((8, 64, 64), 3), ((8, 65, 64), 3), ((5, 4, 7), 3), ((5, 5, 7), 3),
]]

_SPMV_PARAMS = (
    [pytest.param(*c, np.float64, id=f"npts{i}-pads{i}-periodic{i}")
     for i, c in enumerate(CASES)]
    + [pytest.param(*c, np.float32, id=f"f32-{i}") for i, c in
       enumerate(CASES)]
    + [pytest.param(*c, dt, id=f"kernel{i}-{np.dtype(dt).name}")
       for i, c in enumerate(KERNEL_CASES) for dt in (np.float64,
                                                       np.float32)])


def f32_sum_bound(n_terms):
    """γ_n = n·u/(1 − n·u): the worst-case relative error of an n-term f32
    sum, taken against Σ|a_k·x_k| (Higham, Accuracy and Stability, §3.1)."""
    u = 2.0 ** -24
    return n_terms * u / (1 - n_terms * u)


@pytest.mark.parametrize("npts,pads,periodic,dtype", _SPMV_PARAMS)
def test_spmv_vs_scipy(npts, pads, periodic, dtype):
    space, A = random_stencil(npts, pads, periodic, seed=42)
    rng = np.random.default_rng(7)
    x_int = rng.standard_normal(npts)
    if dtype == np.float32:
        # the oracle gets the same f32-rounded band and vector in f64
        A = StencilMatrix(space.with_dtype(jnp.float32),
                          band_t=A.band_t.astype(jnp.float32))
        x_int = x_int.astype(np.float32)
    x = StencilVector.from_interior(A.space, x_int)
    y = A.dot(x).interior
    assert y.dtype == jnp.dtype(dtype)
    y = np.asarray(y, np.float64).ravel()
    csr = A.tocsr().astype(np.float64)
    x64 = x_int.astype(np.float64).ravel()
    y_ref = csr @ x64
    if dtype == np.float64:
        np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    else:
        bound = f32_sum_bound(int(np.prod(space.band_shape)))
        scale = abs(csr) @ np.abs(x64)
        assert np.all(np.abs(y - y_ref) <= bound * scale + 1e-30)


@pytest.mark.parametrize("npts,pads,periodic", CASES[:4])
def test_interchange_roundtrip(npts, pads, periodic):
    space, A = random_stencil(npts, pads, periodic, seed=3)
    coo = A.tocoo()
    B = StencilMatrix.from_coo(space, coo.row, coo.col, coo.data)
    np.testing.assert_allclose(np.asarray(B.band), np.asarray(A.band),
                               rtol=0, atol=1e-14)
    # dense round trip
    np.testing.assert_allclose(B.toarray(), A.toarray(), atol=1e-14)


def test_toarray_matches_manual_1d():
    space, A = random_stencil((6,), (1,), (False,), seed=1)
    D = A.toarray()
    band = np.asarray(A.band)
    for i in range(6):
        for k in range(3):
            j = i + k - 1
            if 0 <= j < 6:
                assert D[i, j] == pytest.approx(band[i, k])


def test_transpose():
    space, A = random_stencil((9, 7), (2, 2), (False, False), seed=5)
    At = A.transpose()
    np.testing.assert_allclose(At.toarray(), A.toarray().T, atol=1e-14)


def test_diagonal():
    space, A = random_stencil((5, 5), (1, 1), (False, False), seed=2)
    np.testing.assert_allclose(np.asarray(A.diagonal()).ravel(),
                               np.diag(A.toarray()), atol=1e-14)


def test_vector_algebra_and_norm():
    space = StencilVectorSpace(npts=(10, 5), pads=(2, 1), periodic=False)
    rng = np.random.default_rng(0)
    a_int = rng.standard_normal((10, 5))
    b_int = rng.standard_normal((10, 5))
    va = StencilVector.from_interior(space, a_int)
    vb = StencilVector.from_interior(space, b_int)
    np.testing.assert_allclose(float(va.dot(vb)), np.vdot(a_int, b_int),
                               rtol=1e-13)
    np.testing.assert_allclose(float(va.norm()), np.linalg.norm(a_int),
                               rtol=1e-13)
    vc = va.axpy(2.5, vb)
    np.testing.assert_allclose(np.asarray(vc.interior), a_int + 2.5 * b_int,
                               rtol=1e-13)


def test_periodic_ghost_wrap():
    space = StencilVectorSpace(npts=(8,), pads=(2,), periodic=True)
    x = StencilVector.from_interior(space, np.arange(8.0))
    xg = x.update_ghost_regions()
    np.testing.assert_allclose(np.asarray(xg.data[:2]), [6.0, 7.0])
    np.testing.assert_allclose(np.asarray(xg.data[-2:]), [0.0, 1.0])


def test_bsr_view():
    space, A = random_stencil((8, 8), (1, 1), (False, False), seed=9)
    bsr = A.tobsr(blocksize=(4, 4))
    np.testing.assert_allclose(bsr.toarray(), A.toarray(), atol=1e-14)
