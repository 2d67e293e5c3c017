"""Tensor-product B-spline Poisson problems (1D/2D/3D).

The reference's example problems (SURVEY.md §2 C13, BASELINE.json configs
1–3): −Δu = f on the unit d-cube with homogeneous Dirichlet conditions,
discretized with degree-p B-splines.  The d-dimensional stiffness operator is
a Kronecker sum of 1D stiffness/mass operators

    A = Σ_a  M_1 ⊗ … ⊗ K_a ⊗ … ⊗ M_d

which in stencil-band form is a sum of outer products of the 1D bands — so
assembly is exact and cheap (host einsum over setup-time 1D quadrature
results) and the operator lands directly in the banded format the SpMV
kernels consume (SURVEY.md §7.0).

Manufactured solution: u(x) = Π_a sin(π x_a), f = d π² u, giving the RHS as
an outer product of 1D sine moments and an O(h^{p+1}) L2-convergence test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from poms_tpu.core.matrix import StencilMatrix
from poms_tpu.core.space import StencilVectorSpace
from poms_tpu.core.vector import StencilVector
from poms_tpu.models.bspline import (Spline1D, assemble_spline_1d,
                                     basis_funs, find_span, sin_moment_1d)

__all__ = ["PoissonProblem", "poisson_problem", "l2_error_manufactured"]


@dataclass
class PoissonProblem:
    dim: int
    degree: int
    n_el: Tuple[int, ...]
    space: StencilVectorSpace
    A: StencilMatrix
    b: StencilVector
    splines: Tuple[Spline1D, ...]


def _kron_sum_band(splines, dtype=None, offset_major: bool = False):
    """Band of Σ_a ⊗(K if dim==a else M).

    Axes are (grid..., offsets...) by default, or the operational
    offset-major (offsets..., grid...) layout with ``offset_major=True``
    (core/matrix.py) — emitting it directly avoids a GB-scale device
    transpose at setup.

    Composed ON DEVICE with jnp.einsum from the tiny 1D bands: the d-D band
    is GB-scale for 3D problems and should not cross the host↔device link.
    """
    d = len(splines)
    dt = dtype or jnp.float64
    Ks = [jnp.asarray(s.K, dt) for s in splines]
    Ms = [jnp.asarray(s.M, dt) for s in splines]
    total = None
    for a in range(d):
        factors = [Ks[b] if b == a else Ms[b] for b in range(d)]
        in_subs = []
        out_grid, out_off = [], []
        for b in range(d):
            gi, oi = chr(ord("a") + b), chr(ord("n") + b)
            in_subs.append(gi + oi)
            out_grid.append(gi)
            out_off.append(oi)
        out = ("".join(out_off) + "".join(out_grid) if offset_major
               else "".join(out_grid) + "".join(out_off))
        expr = ",".join(in_subs) + "->" + out
        term = jnp.einsum(expr, *factors)
        total = term if total is None else total + term
    return total


def poisson_problem(dim: int, n_el, degree: int = 3,
                    dtype=jnp.float64,
                    operator: str = "banded") -> PoissonProblem:
    """Assemble the d-D Poisson system (stiffness A, manufactured-RHS b).

    ``operator='banded'`` materializes the full (2p+1)^d-per-point band on
    device (GB-scale for large 3D grids); ``'kron'`` keeps A in the O(n)
    Kronecker-sum form (core/kron.py) — required for grids where the band
    would not fit HBM.
    """
    if isinstance(n_el, int):
        n_el = (n_el,) * dim
    n_el = tuple(int(x) for x in n_el)
    if len(n_el) != dim:
        raise ValueError(f"n_el {n_el} does not match dim {dim}")
    splines = tuple(assemble_spline_1d(ne, degree) for ne in n_el)
    npts = tuple(s.n for s in splines)
    space = StencilVectorSpace(npts=npts, pads=degree, periodic=False,
                               dtype=dtype)
    if operator == "kron":
        from poms_tpu.mg.hierarchy import _kron_operator_from_1d

        A = _kron_operator_from_1d([(s.K, s.M) for s in splines], space)
    else:
        band_t = _kron_sum_band(splines, dtype, offset_major=True)
        A = StencilMatrix.from_band_t(space, band_t)
    # RHS: f = d π² Π sin(π x_a)  →  b = d π² ⊗_a s_a  (device outer product,
    # via broadcast MULTIPLIES, not tensordot, which at 512³ can
    # materialize a large dot_general temporary; the multiply streams)
    moments = [jnp.asarray(sin_moment_1d(s, m=1, interior=True), dtype)
               for s in splines]
    b_int = moments[0]
    for m in moments[1:]:
        b_int = b_int[..., None] * m
    b_int = dim * np.pi ** 2 * b_int
    b = StencilVector.from_interior(space, b_int)
    return PoissonProblem(dim=dim, degree=degree, n_el=n_el, space=space,
                          A=A, b=b, splines=splines)


def _collocation_interior(sp: Spline1D, xs: np.ndarray) -> np.ndarray:
    """Dense (len(xs), n_interior) matrix of interior basis values at xs."""
    C = np.zeros((len(xs), sp.nb))
    for m, x in enumerate(xs):
        k = find_span(sp.knots, sp.degree, x)
        C[m, k - sp.degree:k + 1] = basis_funs(sp.knots, sp.degree, k, x)
    return C[:, 1:-1]


def l2_error_manufactured(problem: PoissonProblem, u: StencilVector,
                          pts_per_dim: int = 64) -> float:
    """L2 error of the discrete solution vs u = Π sin(π x_a) (host-side)."""
    d = problem.dim
    xs = (np.arange(pts_per_dim) + 0.5) / pts_per_dim  # midpoint rule
    Cs = [_collocation_interior(s, xs) for s in problem.splines]
    vals = np.asarray(u.interior)
    for a in range(d):
        vals = np.tensordot(Cs[a], vals, axes=([1], [a]))
        vals = np.moveaxis(vals, 0, a)
    exact = np.sin(np.pi * xs)
    ex = exact
    for _ in range(d - 1):
        ex = np.multiply.outer(ex, exact)
    w = (1.0 / pts_per_dim) ** d
    return float(np.sqrt(np.sum((vals - ex) ** 2) * w))
