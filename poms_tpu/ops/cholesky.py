"""Coarsest-grid direct solve (SURVEY.md §2 C11).

The reference delegates to scipy's SuperLU/LAPACK [recall:low]; the
device equivalent factors the (tiny) coarsest Galerkin operator once at
setup with a dense Cholesky and back-substitutes on device each cycle —
two triangular solves, no host round-trip.  An f64 path is used throughout
(the coarsest system is small, so this is cheap).
A scipy sparse-LU parity path lives in :mod:`poms_tpu.oracle`.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DenseCholesky", "factor_dense_cholesky"]


@jax.tree_util.register_pytree_node_class
@dataclass
class DenseCholesky:
    """Lower-triangular Cholesky factor of the flattened coarse operator."""
    L: jnp.ndarray

    def solve(self, b_flat: jnp.ndarray) -> jnp.ndarray:
        y = jax.scipy.linalg.solve_triangular(self.L, b_flat, lower=True)
        return jax.scipy.linalg.solve_triangular(self.L.T, y, lower=False)

    def tree_flatten(self):
        return (self.L,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        (L,) = children
        return cls(L=children[0])


def factor_dense_cholesky(A_stencil, dtype=None) -> DenseCholesky:
    """Factor a StencilMatrix's dense form (host assembly, device factor)."""
    Ad = A_stencil.toarray()  # host numpy (setup-time, coarsest level only)
    dtype = dtype or A_stencil.space.dtype
    L = jnp.linalg.cholesky(jnp.asarray(Ad, dtype))
    return DenseCholesky(L=L)
