"""Banded-operator kernels used by the matrices, smoothers and cycles.

Each entry point is a plain ``jnp`` body that XLA fuses into one loop per
call: the shifted multiply-adds of :mod:`poms_tpu.ops.spmv` plus the
elementwise update around them.  All take the **offset-major** band
(``band_t[k..., i...]`` — see poms_tpu/core/matrix.py).
"""
from __future__ import annotations

import jax.numpy as jnp

from poms_tpu.ops.spmv import spmv_banded_jnp, spmv_offdiag_jnp

__all__ = ["spmv", "residual", "jacobi", "rbgs_color"]


def _interior(x_pad, npts, pads):
    return x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]


def spmv(band_t, x_pad, npts, pads):
    """y = A·x on the interior, ghosts of ``x_pad`` already up to date."""
    return spmv_banded_jnp(band_t, x_pad, npts, pads)


def residual(band_t, x_pad, b_int, npts, pads):
    """r = b − A·x."""
    return b_int - spmv_banded_jnp(band_t, x_pad, npts, pads)


def jacobi(band_t, x_pad, b_int, omega, npts, pads):
    """x' = x + ω (b − A x)/diag."""
    diag = band_t[tuple(pads)]
    Ax = spmv_banded_jnp(band_t, x_pad, npts, pads)
    return _interior(x_pad, npts, pads) + omega * (b_int - Ax) / diag


def rbgs_color(band_t, x_pad, b_int, omega, color, npts, pads, starts=None):
    """One RB-GS color phase: masked hybrid-GS update on color-``color``
    points (``starts``: the block's global offsets, which fix the colors
    under a sharded grid)."""
    from poms_tpu.mg.smoother import color_mask

    diag = band_t[tuple(pads)]
    x_int = _interior(x_pad, npts, pads)
    s = spmv_offdiag_jnp(band_t, x_pad, npts, pads)
    gs = (b_int - s) / diag
    mask = color_mask(npts, color, starts)
    return jnp.where(mask, (1.0 - omega) * x_int + omega * gs, x_int)
