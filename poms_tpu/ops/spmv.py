"""Banded stencil SpMV — the jnp implementation.

A tensor-product B-spline stencil matrix is a dense small-band array, and
stencil SpMV is a sum of ``(2p+1)^d`` *shifted dense multiply-adds* over
the ghost-padded input vector (SURVEY.md §7.0):

    out[i] = sum_k  band_t[k, i] * x_pad[i + k]          (k in [0, 2p]^d)

which XLA fuses into a single streaming loop — no gather/scatter, pure
memory-bound streaming.  It plays the part of the reference's
pyccel-generated Fortran ``stencil_dot_1d/2d/3d`` kernels (SURVEY.md §2 C5).

Layout note — **offset-major** (``band_t[k..., i...]``, the DIA layout): the
(2p+1)^d offset indices are the *major* dims, so each coefficient plane
``band_t[k]`` is a contiguous grid-shaped array and every read of the band
is unit-stride.  The grid-major layout (``band[i..., k...]``) would make
every coefficient read a stride-(2p+1)^d gather.
:class:`poms_tpu.core.matrix.StencilMatrix` stores ``band_t`` and exposes
grid-major ``.band`` only as a construction/interchange view.
"""
from __future__ import annotations

import itertools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["spmv_banded_jnp", "spmv_offdiag_jnp", "diagonal_band_index"]


def diagonal_band_index(pads: Tuple[int, ...]) -> Tuple[int, ...]:
    """Band index of the matrix diagonal: offset 0 lives at k = p per dim."""
    return tuple(pads)


def _band_offsets(pads: Tuple[int, ...]):
    """All band index tuples k in [0, 2p]^d (static Python iteration)."""
    return itertools.product(*[range(2 * p + 1) for p in pads])


@partial(jax.jit, static_argnames=("npts", "pads"))
def spmv_banded_jnp(band_t: jnp.ndarray, x_pad: jnp.ndarray,
                    npts: Tuple[int, ...], pads: Tuple[int, ...]) -> jnp.ndarray:
    """out[i] = sum_k band_t[k, i] * x_pad[i + k].

    Parameters
    ----------
    band_t : array of shape ``(2p+1 per dim) + npts`` — stencil coefficients,
        offset-major.  ``band_t[k, i]`` multiplies ``x[i + k - p]`` in
        interior coordinates.
    x_pad : array of shape ``n + 2p`` per dim, ghosts already up to date.

    Returns the interior result of shape ``npts``.
    """
    out = None
    for k in _band_offsets(pads):
        shifted = jax.lax.slice(
            x_pad, k, tuple(ki + ni for ki, ni in zip(k, npts)))
        term = band_t[k] * shifted
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("npts", "pads"))
def spmv_offdiag_jnp(band_t: jnp.ndarray, x_pad: jnp.ndarray,
                     npts: Tuple[int, ...], pads: Tuple[int, ...]) -> jnp.ndarray:
    """Like :func:`spmv_banded_jnp` but skipping the diagonal term.

    Used by Jacobi/Gauss–Seidel sweeps:  (A x)_offdiag = A x − diag(A)·x.
    """
    diag_k = diagonal_band_index(pads)
    out = None
    for k in _band_offsets(pads):
        if k == diag_k:
            continue
        shifted = jax.lax.slice(
            x_pad, k, tuple(ki + ni for ki, ni in zip(k, npts)))
        term = band_t[k] * shifted
        out = term if out is None else out + term
    if out is None:  # pads all zero: purely diagonal matrix
        out = jnp.zeros(npts, band_t.dtype)
    return out
