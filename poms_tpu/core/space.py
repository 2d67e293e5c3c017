"""Stencil vector spaces — index metadata for tensor-product B-spline grids.

TPU-native analogue of the reference's ``StencilVectorSpace`` (SURVEY.md §2 C1,
[recall:high]; reference checkout unavailable, see SURVEY.md §0): holds the
number of basis functions per dimension, the pad (ghost/halo) width per
dimension (= spline degree for B-spline operators), periodicity flags and the
dtype.  Unlike the reference (which owns an MPI ``CartDecomposition``), the
distributed story lives in :mod:`poms_tpu.parallel` — spaces stay purely
logical and the same space object describes the *global* problem whether it is
run on one chip or sharded over a mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import jax.numpy as jnp

__all__ = ["StencilVectorSpace"]


def _as_tuple(x, d, name):
    if isinstance(x, (int, bool)):
        return (x,) * d
    t = tuple(x)
    if len(t) != d:
        raise ValueError(f"{name} must have length {d}, got {t}")
    return t


@dataclass(frozen=True)
class StencilVectorSpace:
    """Metadata for a d-dimensional tensor-product stencil space.

    Parameters
    ----------
    npts : tuple[int, ...]
        Number of (interior, after Dirichlet elimination) basis functions per
        dimension.
    pads : tuple[int, ...]
        Ghost/pad width per dimension, per side.  For a degree-``p`` B-spline
        operator the band is ``2p+1`` wide so the pad is ``p``
        (SURVEY.md §5.7 — "degree-wide halos").
    periodic : tuple[bool, ...]
        Periodicity per dimension.  Non-periodic ghosts are zero (Dirichlet-
        eliminated operators never reference outside the interior).
    dtype : jnp dtype for field data (default float64).
    """

    npts: Tuple[int, ...]
    pads: Tuple[int, ...]
    periodic: Tuple[bool, ...] = None  # type: ignore[assignment]
    dtype: jnp.dtype = jnp.float64

    def __post_init__(self):
        d = len(self.npts)
        object.__setattr__(self, "npts", tuple(int(n) for n in self.npts))
        object.__setattr__(self, "pads", _as_tuple(self.pads, d, "pads"))
        per = self.periodic if self.periodic is not None else False
        object.__setattr__(self, "periodic", _as_tuple(per, d, "periodic"))
        object.__setattr__(self, "dtype", jnp.dtype(self.dtype))
        for n, p in zip(self.npts, self.pads):
            if n < 1 or p < 0:
                raise ValueError(f"invalid space: npts={self.npts} pads={self.pads}")

    # -- derived geometry ---------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.npts)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Interior shape (no ghosts)."""
        return self.npts

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        """Shape of the backing array including ghost regions."""
        return tuple(n + 2 * p for n, p in zip(self.npts, self.pads))

    @property
    def band_shape(self) -> Tuple[int, ...]:
        """Shape of the per-row stencil band: (2p+1) per dimension."""
        return tuple(2 * p + 1 for p in self.pads)

    @property
    def size(self) -> int:
        return math.prod(self.npts)

    @property
    def interior(self) -> Tuple[slice, ...]:
        """Slices selecting the interior of a padded array."""
        return tuple(slice(p, p + n) for n, p in zip(self.npts, self.pads))

    def with_dtype(self, dtype) -> "StencilVectorSpace":
        return replace(self, dtype=jnp.dtype(dtype))

    def coarsen(self) -> "StencilVectorSpace":
        """Space of the next-coarser dyadic level (see models/bspline.py for
        how npts maps under dyadic knot coarsening: n -> (n - p)/2 + p for
        open knot vectors with Dirichlet elimination, i.e. elements halve)."""
        raise NotImplementedError("use models.bspline.coarsen_space (needs degree info)")
