"""Banded ("DIA-of-offsets") stencil matrices with sparse interchange.

Analogue of the reference's ``StencilMatrix`` (SURVEY.md §2 C3,
[recall:high]): for each grid multi-index ``i`` the ``(2p+1)^d`` band of
nonzeros is stored by diagonal offset.  This is the *primary* operator
format (BASELINE.json:5 "stored as banded/BSR"); CSR/COO are
interchange/oracle formats only (SURVEY.md §7.0, §4).

Storage layout: the canonical array is **offset-major** ``band_t`` of shape
``band_shape + npts`` — ``band_t[k, i]`` multiplies ``x[i + k - p]``.  Each
coefficient plane is a contiguous grid-shaped array, so the shifted-MAC
SpMV streams the band with unit-stride reads (see poms_tpu/ops/spmv.py).
The grid-major view ``band[i, k]`` is exposed as a property for
construction and host-side interchange only.

Conversions run on host in numpy (setup/test-time only).  The hot path is
:meth:`StencilMatrix.dot` → :func:`poms_tpu.ops.spmv.spmv_banded_jnp`.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from poms_tpu.core.space import StencilVectorSpace
from poms_tpu.core.vector import StencilVector
from poms_tpu.ops import dispatch as _ops

__all__ = ["StencilMatrix"]


def _to_offset_major(band, nd: int):
    """(npts..., win...) → (win..., npts...)."""
    return jnp.transpose(band, tuple(range(nd, 2 * nd)) + tuple(range(nd)))


def _to_grid_major(band_t, nd: int):
    """(win..., npts...) → (npts..., win...)."""
    return jnp.transpose(band_t, tuple(range(nd, 2 * nd)) + tuple(range(nd)))


@jax.tree_util.register_pytree_node_class
class StencilMatrix:
    """Banded stencil operator mapping a space to itself.

    ``band_t`` has shape ``space.band_shape + space.npts``.  Rows whose
    stencil would reach outside the (non-periodic) domain must carry zeros
    there — the B-spline assembly in :mod:`poms_tpu.models` guarantees this,
    and :meth:`validate_boundary` checks it.
    """

    __slots__ = ("space", "band_t")

    def __init__(self, space: StencilVectorSpace,
                 band: jnp.ndarray | None = None, *,
                 band_t: jnp.ndarray | None = None):
        self.space = space
        nd = space.ndim
        if band_t is not None:
            self.band_t = band_t
        elif band is not None:
            self.band_t = _to_offset_major(jnp.asarray(band), nd)
        else:
            self.band_t = jnp.zeros(space.band_shape + space.npts,
                                    space.dtype)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_band(cls, space: StencilVectorSpace, band) -> "StencilMatrix":
        """From a grid-major ``(npts..., win...)`` band array."""
        band = jnp.asarray(band, space.dtype)
        want = space.npts + space.band_shape
        if band.shape != want:
            raise ValueError(f"band shape {band.shape} != {want}")
        return cls(space, band)

    @classmethod
    def from_band_t(cls, space: StencilVectorSpace, band_t) -> "StencilMatrix":
        """From an offset-major ``(win..., npts...)`` band array."""
        band_t = jnp.asarray(band_t, space.dtype)
        want = space.band_shape + space.npts
        if band_t.shape != want:
            raise ValueError(f"band_t shape {band_t.shape} != {want}")
        return cls(space, band_t=band_t)

    @property
    def band(self) -> jnp.ndarray:
        """Grid-major view ``band[i, k]`` (construction/interchange only —
        transposes; the operational layout is :attr:`band_t`)."""
        return _to_grid_major(self.band_t, self.space.ndim)

    # -- linear-operator interface -----------------------------------------
    def dot(self, v: StencilVector) -> StencilVector:
        """y = A v. Refreshes ghosts, then the banded SpMV (SURVEY.md §3.4)."""
        vg = v.update_ghost_regions()
        out_int = _ops.spmv(self.band_t, vg.data, self.space.npts,
                            self.space.pads)
        return StencilVector.from_interior(self.space, out_int)

    def __matmul__(self, v: StencilVector) -> StencilVector:
        return self.dot(v)

    def diagonal(self) -> jnp.ndarray:
        """Main diagonal as an interior-shaped array."""
        return self.band_t[tuple(self.space.pads)]

    # -- host-side interchange (SURVEY.md §2 C4) ---------------------------
    def _coo_arrays(self):
        """(rows, cols, vals) over the flattened interior index space.

        Out-of-range entries wrap for periodic dims and are *asserted zero*
        then dropped for non-periodic dims.
        """
        sp = self.space
        band_t = np.asarray(self.band_t)
        npts, pads, periodic = sp.npts, sp.pads, sp.periodic
        nd = sp.ndim
        grids = np.meshgrid(*[np.arange(n) for n in npts], indexing="ij")
        rows_md = [g.ravel() for g in grids]

        rows_l, cols_l, vals_l = [], [], []
        for k in itertools.product(*[range(2 * p + 1) for p in pads]):
            vals = band_t[k].ravel()
            cols_md = []
            valid = np.ones(vals.shape, bool)
            for a in range(nd):
                c = rows_md[a] + (k[a] - pads[a])
                if periodic[a]:
                    c = c % npts[a]
                else:
                    valid &= (c >= 0) & (c < npts[a])
                cols_md.append(c)
            # flatten multi-index (C order)
            rflat = np.zeros(vals.shape, np.int64)
            cflat = np.zeros(vals.shape, np.int64)
            for a in range(nd):
                rflat = rflat * npts[a] + rows_md[a]
                cflat = cflat * npts[a] + np.where(valid, cols_md[a], 0)
            oob = ~valid
            if oob.any() and np.abs(vals[oob]).max() > 0:
                raise ValueError(
                    "nonzero stencil coefficient reaches outside a "
                    "non-periodic domain — assembly bug")
            keep = valid & (vals != 0)
            rows_l.append(rflat[keep])
            cols_l.append(cflat[keep])
            vals_l.append(vals[keep])
        rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
        cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
        vals = np.concatenate(vals_l) if vals_l else np.zeros(0, band_t.dtype)
        return rows, cols, vals

    def tocoo(self):
        """scipy.sparse.coo_matrix over flattened interior indices."""
        import scipy.sparse as sps

        rows, cols, vals = self._coo_arrays()
        n = self.space.size
        return sps.coo_matrix((vals, (rows, cols)), shape=(n, n))

    def tocsr(self):
        return self.tocoo().tocsr()

    def tobsr(self, blocksize=None):
        """Native BSR storage (banded/BSR parity — BASELINE.json:5).

        Returns :class:`poms_tpu.sparse.bsr.BsrMatrix` built directly from
        the stencil's COO triplets.  Default block size: the last grid dim's
        band count (2·p_last + 1) if it tiles the matrix, else 1×1.
        """
        from poms_tpu.sparse.bsr import BsrMatrix

        n = self.space.size
        if blocksize is None:
            w = 2 * self.space.pads[-1] + 1
            b = w if n % w == 0 else 1
            blocksize = (b, b)
        rows, cols, vals = self._coo_arrays()
        return BsrMatrix.from_coo(rows, cols, vals, (n, n), blocksize)

    def toarray(self):
        return self.tocoo().toarray()

    @classmethod
    def from_coo(cls, space: StencilVectorSpace, rows, cols, vals,
                 tol: float = 0.0) -> "StencilMatrix":
        """Inverse of :meth:`tocoo` — scatter flat COO into the band.

        Entries outside the band raise (choose pads large enough — RAP grows
        bands, see mg/hierarchy.py).  Duplicate (row, col) entries are summed.
        ``tol`` drops entries with |v| <= tol first (RAP of *nested* spaces is
        exactly banded, but floating point leaves ~1e-16 junk outside the
        band — SURVEY.md §7.2.4).
        """
        sp = space
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if tol > 0.0:
            keep = np.abs(vals) > tol
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        nd, npts, pads = sp.ndim, sp.npts, sp.pads

        band_t = np.zeros(sp.band_shape + npts, np.float64)
        # unflatten row/col multi-indices
        r_md, c_md = [], []
        r, c = rows.copy(), cols.copy()
        for a in reversed(range(nd)):
            r_md.insert(0, r % npts[a]); r //= npts[a]
            c_md.insert(0, c % npts[a]); c //= npts[a]
        k_md = []
        for a in range(nd):
            off = c_md[a] - r_md[a]
            if sp.periodic[a]:
                n = npts[a]
                off = (off + n // 2) % n - n // 2  # wrap to nearest
            k = off + pads[a]
            if ((k < 0) | (k >= 2 * pads[a] + 1)).any():
                raise ValueError(
                    f"COO entry outside band in dim {a}: pads={pads} too small")
            k_md.append(k)
        idx = tuple(k_md) + tuple(r_md)
        np.add.at(band_t, idx, vals)
        return cls(space, band_t=jnp.asarray(band_t, sp.dtype))

    @classmethod
    def from_scipy(cls, space: StencilVectorSpace, mat) -> "StencilMatrix":
        coo = mat.tocoo()
        return cls.from_coo(space, coo.row, coo.col, coo.data)

    # -- structural ops ----------------------------------------------------
    def transpose(self) -> "StencilMatrix":
        """A^T in the same band format (SURVEY.md §2 C3 `.transpose()`)."""
        rows, cols, vals = self._coo_arrays()
        return StencilMatrix.from_coo(self.space, cols, rows, vals)

    @property
    def T(self) -> "StencilMatrix":
        return self.transpose()

    def __add__(self, other: "StencilMatrix") -> "StencilMatrix":
        return StencilMatrix(self.space, band_t=self.band_t + other.band_t)

    def __mul__(self, scalar) -> "StencilMatrix":
        return StencilMatrix(self.space, band_t=self.band_t * scalar)

    __rmul__ = __mul__

    def validate_boundary(self) -> bool:
        """True iff no nonzero coefficient escapes a non-periodic boundary."""
        try:
            self._coo_arrays()
            return True
        except ValueError:
            return False

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.band_t,), self.space

    @classmethod
    def tree_unflatten(cls, space, children):
        return cls(space, band_t=children[0])

    def __repr__(self):
        return (f"StencilMatrix(npts={self.space.npts}, "
                f"band={self.space.band_shape})")
