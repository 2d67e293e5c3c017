"""Halo exchange and distributed stencil primitives (inside shard_map).

Replacement for the reference's MPI Cartesian communication layer
(SURVEY.md §2 C9/C10, §5.7/8): the d-dimensional grid is block-partitioned
over a `jax.sharding.Mesh` with one axis per grid dimension, and the
degree-wide ghost slabs are exchanged with per-dimension `lax.ppermute`
shifts — the ring/neighbor idiom of the scaling-book recipe.  Dirichlet
boundaries fall out for free: edge devices receive *zeros* from the
non-wrapping ppermute, which is exactly the eliminated-boundary condition
(core/vector.py).  Periodic dims use wrapping permutations (including the
self-permutation when the axis has a single device, which reproduces the
serial wrap).

All functions here are pure and MUST be called inside `jax.shard_map` with
the grid dims mapped to the named mesh axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from poms_tpu.ops import dispatch as _ops
from poms_tpu.ops.spmv import spmv_offdiag_jnp

__all__ = ["HaloSpec", "halo_exchange", "pad_and_exchange", "dist_spmv",
           "dist_spmv_offdiag", "dist_norm2", "dist_dot", "local_starts"]


@dataclass(frozen=True)
class AxisSpec:
    name: Optional[str]   # mesh axis name (None = unsharded dim)
    size: int             # number of devices along this axis
    n_loc: int            # local interior extent
    pad: int
    periodic: bool


@dataclass(frozen=True)
class HaloSpec:
    """Static per-dimension communication description."""
    axes: Tuple[AxisSpec, ...]

    @classmethod
    def build(cls, names, mesh_shape, n_loc, pads, periodic) -> "HaloSpec":
        axes = tuple(
            AxisSpec(name=names[a], size=mesh_shape[a], n_loc=n_loc[a],
                     pad=pads[a], periodic=periodic[a])
            for a in range(len(n_loc)))
        return cls(axes=axes)

    @property
    def n_loc(self):
        return tuple(ax.n_loc for ax in self.axes)

    @property
    def pads(self):
        return tuple(ax.pad for ax in self.axes)

    @property
    def names(self):
        return tuple(ax.name for ax in self.axes if ax.name is not None)


def _slice_axis(x, a, start, stop):
    idx = tuple(slice(start, stop) if b == a else slice(None)
                for b in range(x.ndim))
    return x[idx]


def _set_axis(x, a, start, stop, val):
    idx = tuple(slice(start, stop) if b == a else slice(None)
                for b in range(x.ndim))
    return x.at[idx].set(val)


def halo_exchange(x_pad: jnp.ndarray, spec: HaloSpec) -> jnp.ndarray:
    """Fill ghost slabs of a local padded block from mesh neighbors.

    ``x_pad`` must enter with zero ghosts (build it with jnp.pad).  One
    ppermute pair per sharded dim; zero-filled receives at non-periodic
    edges (SURVEY.md §3.4's update_ghost_regions, distributed form).
    """
    for a, ax in enumerate(spec.axes):
        p, n, m = ax.pad, ax.n_loc, ax.size
        if p == 0:
            continue
        if ax.name is None:
            if ax.periodic:
                x_pad = _set_axis(x_pad, a, 0, p,
                                  _slice_axis(x_pad, a, n, n + p))
                x_pad = _set_axis(x_pad, a, p + n, p + n + p,
                                  _slice_axis(x_pad, a, p, 2 * p))
            continue  # non-periodic unsharded: ghosts already zero
        # slabs of interior data
        right_slab = _slice_axis(x_pad, a, n, n + p)      # last p interior
        left_slab = _slice_axis(x_pad, a, p, 2 * p)       # first p interior
        fwd = [(i, i + 1) for i in range(m - 1)]
        bwd = [(i + 1, i) for i in range(m - 1)]
        if ax.periodic:
            fwd.append((m - 1, 0))
            bwd.append((0, m - 1))
        from_left = jax.lax.ppermute(right_slab, ax.name, fwd)
        from_right = jax.lax.ppermute(left_slab, ax.name, bwd)
        x_pad = _set_axis(x_pad, a, 0, p, from_left)
        x_pad = _set_axis(x_pad, a, p + n, p + n + p, from_right)
    return x_pad


def pad_and_exchange(x_loc: jnp.ndarray, spec: HaloSpec) -> jnp.ndarray:
    x_pad = jnp.pad(x_loc, [(ax.pad, ax.pad) for ax in spec.axes])
    return halo_exchange(x_pad, spec)


def dist_spmv(band_loc: jnp.ndarray, x_loc: jnp.ndarray,
              spec: HaloSpec, overlap: bool = False) -> jnp.ndarray:
    """Distributed banded SpMV: halo exchange + local shifted-MAC sum.

    ``overlap=True`` uses the comm/compute-overlap formulation
    (SURVEY.md §7.1.7): by linearity,

        A·x = A·(x with zero ghosts)  +  A·(ghosts only)

    The first term needs NO communication and covers all interior work;
    the second touches only the p-wide boundary shells.  Emitting the
    ppermute and the big interior SpMV as *independent* ops lets XLA
    schedule the halo transfer concurrently with interior compute —
    verify in profiler traces on several real cards (one device can only
    test equivalence, which tests/test_dist.py does).
    """
    if not overlap:
        x_pad = pad_and_exchange(x_loc, spec)
        return _ops.spmv(band_loc, x_pad, spec.n_loc, spec.pads)
    nd = len(spec.axes)
    n_loc, pads = spec.n_loc, spec.pads
    # interior term: zero ghosts — NO dependency on the ppermutes
    x_pad0 = jnp.pad(x_loc, [(ax.pad, ax.pad) for ax in spec.axes])
    out = _ops.spmv(band_loc, x_pad0, n_loc, pads)
    # ghost-only field: real exchange, then zero the interior (linearity)
    x_ex = halo_exchange(x_pad0, spec)
    interior = tuple(slice(ax.pad, ax.pad + ax.n_loc) for ax in spec.axes)
    x_ghost = x_ex.at[interior].set(jnp.zeros(n_loc, x_ex.dtype))
    # correction only touches rows within `pad` of a face; compute it on a
    # DISJOINT face partition (face (a, side) owns rows with dim a in the
    # edge slab and dims b < a interior) — O(surface) extra work
    for a in range(nd):
        p_a = pads[a]
        if p_a == 0:
            continue
        for side in (0, 1):
            row_sel = []
            for b in range(nd):
                if b < a:
                    row_sel.append(slice(pads[b],
                                         max(pads[b], n_loc[b] - pads[b])))
                elif b == a:
                    # the two opposite slabs must stay disjoint even when
                    # n_loc < 2p (then side 0 absorbs the overlap rows)
                    row_sel.append(
                        slice(0, min(p_a, n_loc[a])) if side == 0
                        else slice(max(p_a, n_loc[a] - p_a), n_loc[a]))
                else:
                    row_sel.append(slice(0, n_loc[b]))
            row_sel = tuple(row_sel)
            shape = tuple(s.stop - s.start for s in row_sel)
            if any(e <= 0 for e in shape):
                continue
            # offset-major band: grid rows are the trailing nd dims
            band_sl = band_loc[(slice(None),) * nd + row_sel]
            xw = x_ghost[tuple(slice(s.start, s.stop + 2 * pads[b])
                               for b, s in enumerate(row_sel))]
            corr = _ops.spmv(band_sl, xw, shape, pads)
            out = out.at[row_sel].add(corr)
    return out


def dist_spmv_offdiag(band_loc: jnp.ndarray, x_loc: jnp.ndarray,
                      spec: HaloSpec) -> jnp.ndarray:
    x_pad = pad_and_exchange(x_loc, spec)
    return spmv_offdiag_jnp(band_loc, x_pad, spec.n_loc, spec.pads)


def dist_dot(a_loc: jnp.ndarray, b_loc: jnp.ndarray, spec: HaloSpec):
    """Global inner product: local reduce + psum over all mesh axes
    (the reference's MPI.Allreduce — SURVEY.md §3.1)."""
    local = jnp.vdot(a_loc, b_loc)
    names = spec.names
    return jax.lax.psum(local, names) if names else local


def dist_norm2(a_loc: jnp.ndarray, spec: HaloSpec):
    return jnp.sqrt(dist_dot(a_loc, a_loc, spec))


def local_starts(spec: HaloSpec) -> Tuple:
    """Global starting index of this device's block, per dim (traced)."""
    starts = []
    for ax in spec.axes:
        if ax.name is None:
            starts.append(0)
        else:
            starts.append(jax.lax.axis_index(ax.name) * ax.n_loc)
    return tuple(starts)
