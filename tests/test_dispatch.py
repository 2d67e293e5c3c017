"""Banded residual, Jacobi and red-black Gauss–Seidel passes
(poms_tpu/ops/dispatch.py) against the scipy CSR oracle."""
import numpy as np
import pytest

from poms_tpu.core.vector import StencilVector
from poms_tpu.ops import dispatch

from test_stencil import KERNEL_CASES, random_stencil

OMEGA = 0.7


def _operands(npts, pads, periodic):
    space, A = random_stencil(npts, pads, periodic, seed=11)
    # smoothers divide by a diagonally dominant diagonal
    A = type(A)(space, band_t=A.band_t.at[tuple(pads)].add(5.0))
    rng = np.random.default_rng(13)
    x = rng.standard_normal(npts)
    b = rng.standard_normal(npts)
    x_pad = StencilVector.from_interior(space, x).update_ghost_regions().data
    return space, A, x, b, x_pad


def _color_mask(npts, color, start):
    idx = np.indices(npts).sum(axis=0) + start * len(npts)
    return idx % 2 == color


@pytest.mark.parametrize("op", ["residual", "jacobi", "rbgs_starts0",
                                "rbgs_starts1"])
@pytest.mark.parametrize("npts,pads,periodic", KERNEL_CASES)
def test_dispatch_vs_scipy(op, npts, pads, periodic):
    space, A, x, b, x_pad = _operands(npts, pads, periodic)
    csr = A.tocsr()
    diag = csr.diagonal().reshape(npts)
    Ax = (csr @ x.ravel()).reshape(npts)
    if op == "residual":
        out = dispatch.residual(A.band_t, x_pad, b, npts, pads)
        np.testing.assert_allclose(np.asarray(out), b - Ax, rtol=1e-12,
                                   atol=1e-12)
    elif op == "jacobi":
        out = dispatch.jacobi(A.band_t, x_pad, b, OMEGA, npts, pads)
        ref = x + OMEGA * (b - Ax) / diag
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12,
                                   atol=1e-12)
    else:
        start = int(op[-1])
        gs = (b - (Ax - diag * x)) / diag
        for color in (0, 1):
            out = dispatch.rbgs_color(A.band_t, x_pad, b, OMEGA, color,
                                      npts, pads,
                                      starts=(start,) * len(npts))
            ref = np.where(_color_mask(npts, color, start),
                           (1 - OMEGA) * x + OMEGA * gs, x)
            np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12,
                                       atol=1e-12)
