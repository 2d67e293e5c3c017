"""Kronecker-sum operators: structure-exploiting SpMV for tensor products.

An operator class with no counterpart in the reference (SURVEY.md §7.0 —
exploiting structure the MPI design never could): a tensor-product
discretization's operator

    A = Σ_r  B_r^(1) ⊗ B_r^(2) ⊗ … ⊗ B_r^(d)

(for Poisson: d terms, B = K in one slot and M elsewhere) is applied as a
chain of **1D banded contractions along axes**, sharing partial products
across terms:

    3D:  t3 = K₃x, m3 = M₃x               (2 axis passes over x)
         c = M₂m3, dd = K₂m3, e = M₂t3    (3 passes)
         y = K₁c + M₁(dd + e)             (2 passes + add)

Each axis pass is (2p+1) shifted multiply-adds with per-row 1D
coefficients — O(1) coefficient data streamed against O(n) field data,
versus the general banded operator's (2p+1)^d-per-point band stream.  For
3D cubic this cuts memory traffic ~3× and memory ~343×; storage is O(d² · n)
1D bands, so 512³ grids fit trivially.

The general :class:`StencilMatrix` stays the universal format (assembled
operators, RAP products of arbitrary matrices, interchange); Kronecker
operators convert to it exactly via ``to_stencil()``.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from poms_tpu.core.space import StencilVectorSpace
from poms_tpu.core.vector import StencilVector

__all__ = ["KroneckerSumOperator", "apply_band_1d_axis"]


def apply_band_1d_axis(band1: jnp.ndarray, x: jnp.ndarray, axis: int,
                       pad: int, periodic: bool = False) -> jnp.ndarray:
    """y[..., i, ...] = Σ_t band1[i, t] · x_pad[..., i + t, ...].

    ``x`` is unpadded along ``axis``; zero (Dirichlet) or wrapped
    (periodic/circulant) padding is applied here.  band1 has shape
    (n_axis, 2p+1).
    """
    n = x.shape[axis]
    nd = x.ndim
    pad_widths = [(pad, pad) if b == axis else (0, 0) for b in range(nd)]
    x_pad = jnp.pad(x, pad_widths, mode="wrap" if periodic else "constant")
    out = None
    for t in range(2 * pad + 1):
        sl = tuple(slice(t, t + n) if b == axis else slice(None)
                   for b in range(nd))
        bshape = [1] * nd
        bshape[axis] = n
        term = band1[:, t].reshape(bshape) * x_pad[sl]
        out = term if out is None else out + term
    return out


@jax.tree_util.register_pytree_node_class
class KroneckerSumOperator:
    """A = Σ_r ⊗_a B_r^(a), each B a 1D stencil band (n_a, 2p_a+1)."""

    __slots__ = ("space", "terms")

    def __init__(self, space: StencilVectorSpace,
                 terms: Sequence[Sequence[jnp.ndarray]]):
        self.space = space
        self.terms = tuple(tuple(jnp.asarray(B, space.dtype) for B in term)
                           for term in terms)
        for term in self.terms:
            if len(term) != space.ndim:
                raise ValueError("each term needs one 1D band per dim")
            for a, B in enumerate(term):
                if B.shape != (space.npts[a], 2 * space.pads[a] + 1):
                    raise ValueError(
                        f"band {a} has shape {B.shape}, expected "
                        f"{(space.npts[a], 2 * space.pads[a] + 1)}")

    # -- application --------------------------------------------------------
    def _band_labels(self):
        """Static sharing structure: label[a][r] identifies equal band
        objects within axis a (Python identity on the *stored* arrays,
        which are alive for the operator's lifetime — never on tracers)."""
        d = self.space.ndim
        labels = []
        for a in range(d):
            seen = {}
            row = []
            for term in self.terms:
                key = id(term[a])
                if key not in seen:
                    seen[key] = len(seen)
                row.append(seen[key])
            labels.append(row)
        return labels

    def _apply_interior(self, x_int: jnp.ndarray) -> jnp.ndarray:
        """Σ_r ⊗B applied with shared partial products (right-to-left).

        Sharing is keyed by each partial's *application history* (a static
        tuple of band labels) — never by id() of traced values, which is
        unsound under jit (tracer ids get recycled).
        """
        d = self.space.ndim
        pads = self.space.pads
        periodic = self.space.periodic
        labels = self._band_labels()
        partials = {r: x_int for r in range(len(self.terms))}
        hist = {r: () for r in range(len(self.terms))}
        for a in range(d - 1, -1, -1):
            cache = {}
            for r, term in enumerate(self.terms):
                key = hist[r] + (labels[a][r],)
                if key not in cache:
                    cache[key] = apply_band_1d_axis(term[a], partials[r], a,
                                                    pads[a], periodic[a])
                partials[r] = cache[key]
                hist[r] = key
        out = None
        for r in partials:
            out = partials[r] if out is None else out + partials[r]
        return out

    def dot(self, v: StencilVector) -> StencilVector:
        out = self._apply_interior(v.interior)
        return StencilVector.from_interior(self.space, out)

    def __matmul__(self, v):
        return self.dot(v)

    def diagonal(self) -> jnp.ndarray:
        """diag(Σ ⊗B) = Σ ⊗diag(B) — outer products of 1D diagonals."""
        out = None
        for term in self.terms:
            d = None
            for a, B in enumerate(term):
                d1 = B[:, self.space.pads[a]]
                d = d1 if d is None else jnp.tensordot(d, d1, axes=0)
            out = d if out is None else out + d
        return out

    # -- conversions --------------------------------------------------------
    def to_stencil(self):
        """Exact conversion to the general banded format (device einsum)."""
        from poms_tpu.core.matrix import StencilMatrix

        d = self.space.ndim
        total = None
        for term in self.terms:
            in_subs, out_grid, out_off = [], [], []
            for b in range(d):
                gi, oi = chr(ord("a") + b), chr(ord("n") + b)
                in_subs.append(gi + oi)
                out_grid.append(gi)
                out_off.append(oi)
            expr = (",".join(in_subs) + "->" + "".join(out_grid)
                    + "".join(out_off))
            t = jnp.einsum(expr, *term)
            total = t if total is None else total + t
        return StencilMatrix.from_band(self.space, total)

    def tocsr(self):
        return self.to_stencil().tocsr()

    def toarray(self):
        return self.to_stencil().toarray()

    def transpose(self) -> "KroneckerSumOperator":
        """Aᵀ = Σ ⊗Bᵀ; 1D band transpose: Bt[i, k] = B[i+k-p, 2p-k]
        (row index wrapped on periodic/circulant dims)."""
        new_terms = []
        for term in self.terms:
            nt = []
            for a, B in enumerate(term):
                p = self.space.pads[a]
                n = self.space.npts[a]
                Bh = np.asarray(B)
                Bt = np.zeros_like(Bh)
                for k in range(2 * p + 1):
                    src_rows = np.arange(n) + (k - p)
                    if self.space.periodic[a]:
                        Bt[:, k] = Bh[src_rows % n, 2 * p - k]
                    else:
                        valid = (src_rows >= 0) & (src_rows < n)
                        Bt[valid, k] = Bh[src_rows[valid], 2 * p - k]
                nt.append(jnp.asarray(Bt, B.dtype))
            new_terms.append(nt)
        return KroneckerSumOperator(self.space, new_terms)

    @property
    def T(self):
        return self.transpose()

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        flat = tuple(B for term in self.terms for B in term)
        return flat, (self.space, len(self.terms))

    @classmethod
    def tree_unflatten(cls, aux, children):
        space, n_terms = aux
        d = space.ndim
        terms = [children[r * d:(r + 1) * d] for r in range(n_terms)]
        obj = object.__new__(cls)
        obj.space = space
        obj.terms = tuple(tuple(t) for t in terms)
        return obj

    def __repr__(self):
        return (f"KroneckerSumOperator(npts={self.space.npts}, "
                f"terms={len(self.terms)})")
