"""Restriction / prolongation application — banded per-axis gathers.

SURVEY.md §2 C8: the reference applies knot-insertion transfer operators as
banded matrices.  Here a tensor-product transfer
P_d = ⊗_a P_1^(a) is applied one axis at a time; each 1D application is a
small static sum of weighted gathers

    y[..., i, ...] = Σ_t  w[i, t] · x[..., c0[i] + t, ...]

with band width W ≈ degree+2, so the whole d-D transfer is d · W fused
gather-multiply-adds — no assembled d-D matrix, no scatter (restriction uses
the band extraction of Pᵀ, which is again a banded *gather*).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TransferBand", "bands_from_dense", "apply_transfer_axis",
           "apply_transfer"]


@jax.tree_util.register_pytree_node_class
@dataclass
class TransferBand:
    """Banded 1D transfer: out[i] = Σ_t w[i, t] * x[c0[i] + t].

    ``w`` has shape (n_out, W); ``c0`` (n_out,) is clipped so that
    c0[i] + W <= n_in, with zero weights padding the clipped rows.
    """
    w: jnp.ndarray
    c0: jnp.ndarray
    n_in: int

    @property
    def n_out(self) -> int:
        return self.w.shape[0]

    @property
    def width(self) -> int:
        return self.w.shape[1]

    def tree_flatten(self):
        return (self.w, self.c0), self.n_in

    @classmethod
    def tree_unflatten(cls, n_in, children):
        w, c0 = children
        return cls(w=w, c0=c0, n_in=n_in)


def bands_from_dense(P: np.ndarray, dtype=jnp.float64) -> TransferBand:
    """Extract the banded form of a dense (n_out, n_in) transfer matrix."""
    P = np.asarray(P)
    n_out, n_in = P.shape
    nz = np.abs(P) > 0.0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    W = int((last - first + 1).max())
    W = min(W, n_in)
    c0 = np.minimum(first, n_in - W).astype(np.int64)
    w = np.zeros((n_out, W))
    for t in range(W):
        w[:, t] = P[np.arange(n_out), c0 + t]
    return TransferBand(w=jnp.asarray(w, dtype), c0=jnp.asarray(c0), n_in=n_in)


@partial(jax.jit, static_argnames=("axis",))
def apply_transfer_axis(tb: TransferBand, x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Apply a 1D banded transfer along one axis of a d-D interior array."""
    nd = x.ndim
    bshape = [1] * nd
    bshape[axis] = tb.n_out
    out = None
    for t in range(tb.width):  # static small loop, XLA-fused
        xt = jnp.take(x, tb.c0 + t, axis=axis)
        wt = tb.w[:, t].reshape(bshape)
        term = wt * xt
        out = term if out is None else out + term
    return out


def apply_transfer(tbs: Tuple[TransferBand, ...], x: jnp.ndarray) -> jnp.ndarray:
    """Apply per-axis banded transfers (tensor-product operator) to x."""
    for a, tb in enumerate(tbs):
        x = apply_transfer_axis(tb, x, a)
    return x
