"""Smoothers: weighted Jacobi, red-black and lexicographic Gauss–Seidel.

SURVEY.md §2 C7 / BASELINE.json configs 1 & 3.  All smoothers are defined on
the banded stencil format and are *exactly* mirrored by the numpy oracle
(:mod:`poms_tpu.oracle`) so residual histories can be compared bit-for-bit
in f64 (SURVEY.md §7.4).

Update rules (these define the semantics the oracle matches):

- ``jacobi``:  x ← x + ω D⁻¹ (b − A x)
- ``rbgs``:    for color c in (red=0, black=1):
                 x[c] ← (1−ω) x[c] + ω D⁻¹ (b − (A x)_offdiag)[c]
  using the *current* x (including this sweep's red update when computing
  black).  Note for wide stencils (p ≥ 2) same-color neighbors exist; they
  contribute their pre-update values within a color phase — the standard
  relaxation choice for high-order stencils, applied consistently here and
  in the oracle.
- ``gs_lex``:  true lexicographic Gauss–Seidel/SOR.  Inherently sequential —
  it runs as a `lax.fori_loop` over rows (correctness/parity path only;
  SURVEY.md §7.2.2 explains why RB is the parallel smoother).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from poms_tpu.core.matrix import StencilMatrix
from poms_tpu.core.vector import StencilVector
from poms_tpu.ops import dispatch as _ops

__all__ = ["SmootherConfig", "smooth_step", "color_mask",
           "jacobi_step", "rbgs_step", "gs_lex_step"]


@dataclass(frozen=True)
class SmootherConfig:
    kind: str = "jacobi"       # 'jacobi' | 'rbgs' | 'gs_lex' | 'chebyshev'
    omega: float | None = None  # damping / SOR factor; None = auto
    cheb_degree: int = 4       # polynomial degree for 'chebyshev'
    cheb_fraction: float = 4.0  # smooth [λmax/fraction, λmax]
    # Auto damping: the classic ω = 2/3 assumes λmax(D⁻¹A) ≈ 2 (low-order
    # FD stencils).  B-spline operators are worse-conditioned in D⁻¹A —
    # measured λmax: 1.59 (1D p3), 1.93 (2D p3), 3.41 (3D p3) — so a fixed
    # 2/3 DIVERGES for 3D cubics.  ``None`` makes the solver estimate λmax
    # by power iteration at setup and use ω = (4/3)/λmax (reduces to ~2/3
    # exactly when λmax = 2).


def estimate_dinv_a_lambda_max(A, iters: int = 30, seed: int = 0) -> float:
    """Power-method estimate of λmax(D⁻¹A) (device-side, setup-time).

    Runs in f32 even for f64 operators: the estimate only parameterizes
    smoothing intervals/damping (1.02–1.05 safety margins dwarf the f32
    rounding), and f32 halves the memory traffic of the 30 power
    iterations.
    """
    if A.space.dtype == jnp.dtype(jnp.float64):
        A = _cast_operator_f32(A)
    sp = A.space

    # A and diag are jit ARGUMENTS, and the start vector is generated ON
    # DEVICE: at 512³ the diagonal is a 539 MB array, which as a closure
    # constant would be embedded in the compiled program.
    @jax.jit
    def iterate(A, diag, seed_arr):
        x = jax.random.normal(jax.random.PRNGKey(seed_arr[0]), sp.npts,
                              sp.dtype)

        def body(_, x):
            v = StencilVector.from_interior(sp, x)
            y = A.dot(v).interior / diag
            return y / jnp.linalg.norm(y)

        x = jax.lax.fori_loop(0, iters, body, x / jnp.linalg.norm(x))
        v = StencilVector.from_interior(sp, x)
        y = A.dot(v).interior / diag
        return jnp.vdot(x, y) / jnp.vdot(x, x)

    return float(iterate(A, A.diagonal(), jnp.asarray([seed], jnp.int32)))


def _cast_operator_f32(A):
    """f32 copy of a banded or Kronecker-sum operator (setup-time only)."""
    sp32 = A.space.with_dtype(jnp.float32)
    if hasattr(A, "terms"):  # KroneckerSumOperator
        from poms_tpu.core.kron import KroneckerSumOperator

        return KroneckerSumOperator(sp32, A.terms)
    return type(A)(sp32, band_t=A.band_t.astype(jnp.float32))


def resolve_omega(cfg: "SmootherConfig", A) -> "SmootherConfig":
    """Fill in an automatic damping factor when omega is None."""
    from dataclasses import replace as _dc_replace

    if cfg.omega is not None or cfg.kind == "chebyshev":
        return cfg
    if cfg.kind in ("rbgs", "gs_lex"):
        return _dc_replace(cfg, omega=1.0)  # GS: ω=1 is safe
    lam = estimate_dinv_a_lambda_max(A) * 1.05  # safety margin
    return _dc_replace(cfg, omega=min(4.0 / 3.0 / lam, 1.0))


def attach_spectral_estimates(levels, cfg: "SmootherConfig"):
    """Per-level λmax(D⁻¹A) estimates (tuple of floats, coarsest None)."""
    if cfg.kind != "chebyshev":
        return tuple(None for _ in levels)
    lams = []
    for lev in levels:
        if getattr(lev, "chol", None) is not None:
            lams.append(None)  # coarsest solves directly
        else:
            lams.append(estimate_dinv_a_lambda_max(lev.A) * 1.02)
    return tuple(lams)


def color_mask(npts: Tuple[int, ...], color: int,
               starts: Tuple[int, ...] | None = None) -> jnp.ndarray:
    """Boolean mask of grid points with (Σ global index) % 2 == color.

    ``starts`` are the global offsets of this block (distributed red-black:
    the color of a point depends on its *global* index — SURVEY.md §7.1.6).
    """
    d = len(npts)
    total = None
    for a, n in enumerate(npts):
        idx = jax.lax.broadcasted_iota(jnp.int32, npts, a)
        if starts is not None:
            idx = idx + starts[a]
        total = idx if total is None else total + idx
    return (total % 2) == color


def jacobi_step(A, x: StencilVector, b: StencilVector,
                omega: float) -> StencilVector:
    sp = A.space
    if hasattr(A, "band_t"):  # banded stencil: one fused pass
        xg = x.update_ghost_regions()
        x_new = _ops.jacobi(A.band_t, xg.data, b.interior, omega, sp.npts,
                            sp.pads)
        return StencilVector.from_interior(sp, x_new)
    # generic linear operator (e.g. KroneckerSumOperator)
    r = b.interior - A.dot(x).interior
    x_new = x.interior + omega * r / A.diagonal()
    return StencilVector.from_interior(sp, x_new)


def rbgs_step(A, x: StencilVector, b: StencilVector,
              omega: float,
              starts: Tuple[int, ...] | None = None) -> StencilVector:
    sp = A.space
    banded = hasattr(A, "band_t")
    if banded:
        # one masked pass per color (ops/dispatch.py::rbgs_color)
        for color in (0, 1):
            xg = x.update_ghost_regions()
            x_new = _ops.rbgs_color(A.band_t, xg.data, b.interior, omega,
                                    color, sp.npts, sp.pads, starts)
            x = StencilVector.from_interior(sp, x_new)
        return x
    diag = A.diagonal()
    for color in (0, 1):
        mask = color_mask(sp.npts, color, starts)
        s = A.dot(x).interior - diag * x.interior  # offdiag = A x − diag·x
        gs_val = (b.interior - s) / diag
        x_new = jnp.where(mask, (1.0 - omega) * x.interior + omega * gs_val,
                          x.interior)
        x = StencilVector.from_interior(sp, x_new)
    return x


@partial(jax.jit, static_argnames=("npts", "pads"), donate_argnums=(1,))
def _gs_lex_sweep(band_t, x_pad, b_int, diag, omega, npts, pads):
    nd = len(npts)
    n_total = math.prod(npts)
    win = tuple(2 * p + 1 for p in pads)
    center = tuple(pads)

    def body(flat, x_pad):
        # decode flat -> multi-index (C order)
        idx = []
        rem = flat
        for a in reversed(range(nd)):
            idx.insert(0, rem % npts[a])
            rem = rem // npts[a]
        idx = tuple(idx)
        window = jax.lax.dynamic_slice(x_pad, idx, win)
        row = jax.lax.dynamic_slice(band_t, (0,) * nd + idx, win + (1,) * nd)
        row = row.reshape(win)
        s = jnp.sum(row * window) - row[center] * window[center]
        d = diag[idx]
        bval = b_int[idx]
        old = window[center]
        new = (1.0 - omega) * old + omega * (bval - s) / d
        return jax.lax.dynamic_update_slice(
            x_pad, new.reshape((1,) * nd),
            tuple(i + p for i, p in zip(idx, pads)))

    return jax.lax.fori_loop(0, n_total, body, x_pad)


def gs_lex_step(A: StencilMatrix, x: StencilVector, b: StencilVector,
                omega: float) -> StencilVector:
    """Sequential lexicographic SOR sweep (non-periodic only)."""
    sp = A.space
    if any(sp.periodic):
        raise NotImplementedError("gs_lex requires non-periodic boundaries")
    xg = x.update_ghost_regions()
    x_pad = _gs_lex_sweep(A.band_t, xg.data, b.interior, A.diagonal(),
                          jnp.asarray(omega, sp.dtype), sp.npts, sp.pads)
    return StencilVector(sp, x_pad)


def chebyshev_step(A, x: StencilVector, b: StencilVector,
                   lam_max: float, degree: int = 4,
                   fraction: float = 4.0) -> StencilVector:
    """One degree-k Chebyshev smoothing application on D⁻¹A.

    Standard preconditioned Chebyshev iteration targeting the smoothing
    interval [λmax/fraction, λmax] — the production smoother for operators
    whose damped-Jacobi factor degrades (high-degree B-splines: SURVEY.md
    §7.2 and PAPERS.md smoother literature).  Fully parallel: ``degree``
    SpMVs, no sequential dependencies or color masks.
    """
    sp = A.space
    lam_min = lam_max / fraction
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    diag = A.diagonal()

    def resid(xv):
        if hasattr(A, "band_t"):
            return _ops.residual(A.band_t, xv.update_ghost_regions().data,
                                 b.interior, sp.npts, sp.pads)
        return b.interior - A.dot(xv).interior

    z = resid(x) / diag
    d = z / theta
    x = StencilVector.from_interior(sp, x.interior + d)
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        z = resid(x) / diag
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = StencilVector.from_interior(sp, x.interior + d)
        rho = rho_new
    return x


def smooth_step(A, x: StencilVector, b: StencilVector,
                cfg: SmootherConfig,
                starts: Tuple[int, ...] | None = None,
                lam_max: float | None = None) -> StencilVector:
    if cfg.kind == "jacobi":
        return jacobi_step(A, x, b, cfg.omega)
    if cfg.kind == "chebyshev":
        if lam_max is None:
            raise ValueError("chebyshev smoother needs a per-level lam_max "
                             "(attach_spectral_estimates)")
        return chebyshev_step(A, x, b, lam_max, cfg.cheb_degree,
                              cfg.cheb_fraction)
    if cfg.kind == "rbgs":
        return rbgs_step(A, x, b, cfg.omega, starts)
    if cfg.kind == "gs_lex":
        if not hasattr(A, "band_t"):
            raise NotImplementedError("gs_lex needs the banded format")
        return gs_lex_step(A, x, b, cfg.omega)
    raise ValueError(f"unknown smoother {cfg.kind!r}")
