"""Distributed multigrid over a device mesh (BASELINE.json configs 4/5).

Architecture (SURVEY.md §7.1.6–7):

- Levels ``0 .. L_dist-1`` are **block-partitioned** over a
  `jax.sharding.Mesh` with one named axis per grid dimension: smoother
  sweeps and residual SpMVs run inside `jax.shard_map` with per-dim
  `ppermute` halo exchange, `psum` norms, and **distributed transfers**
  (per-axis halo-exchange + local banded gather,
  :mod:`poms_tpu.parallel.transfers`).
- Levels below ``L_dist`` are **agglomerated**: the sharded RHS is
  `all_gather`-ed (tiled) and the remaining V/W-cycle runs replicated on
  every device — standard coarse-grid agglomeration; L_dist is chosen
  automatically as the deepest level whose local blocks still fit the
  smoother pads and transfer halos.

Alignment invariant: padded global sizes satisfy ``N_l = 2 · N_{l+1}`` per
dim across the distributed range, so each device owns matching nested
blocks on every distributed level and all transfer communication is a ±W
neighbor halo.  Grid padding uses *decoupled identity rows* (diag 1, zero
coupling, zero RHS, zero transfer weights), which keep padded entries
exactly zero through smoothing, residuals, transfers and norms — tests
assert sharded ≡ serial to f64 roundoff.
"""
from __future__ import annotations

import math
import time
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from poms_tpu.core.vector import StencilVector
from poms_tpu.mg.cycles import CycleConfig, cycle, fmg
from poms_tpu.mg.hierarchy import build_hierarchy
from poms_tpu.mg.solver import SolveResult
from poms_tpu.models.bspline import (prolongation_interior_1d,
                                     prolongation_periodic_1d)
from poms_tpu.ops import dispatch as _ops
from poms_tpu.parallel.halo import (HaloSpec, dist_norm2, dist_spmv,
                                    local_starts, pad_and_exchange)
from poms_tpu.parallel.kron import (dist_dw_norm2, dist_kron_apply,
                                    dist_kron_diag, dist_kron_residual_df,
                                    pad_band_1d_identity)
from poms_tpu.parallel.transfers import (build_dist_transfer,
                                         dist_apply_transfer)

__all__ = ["DistributedMG"]

_AXIS_NAMES = ("ax0", "ax1", "ax2", "ax3")


def _pad_band_identity(band_t: np.ndarray, npts, N, pads) -> np.ndarray:
    """Pad grid dims to N with decoupled identity rows (host, setup-time).

    ``band_t`` is offset-major (win..., npts...); grid dims are the trailing
    ``d`` axes.
    """
    d = len(npts)
    pad_widths = [(0, 0)] * d + [(0, N[a] - npts[a]) for a in range(d)]
    bp = np.pad(np.asarray(band_t), pad_widths)
    diag_idx = tuple(pads)
    mask = np.zeros(N, bool)
    for a in range(d):
        idx = [slice(None)] * d
        idx[a] = slice(npts[a], N[a])
        mask[tuple(idx)] = True
    diag_view = bp[diag_idx]  # basic indexing -> view
    diag_view[mask] = 1.0
    return bp


class _DistLevel:
    """Static + array data for one distributed level (host-side setup)."""

    def __init__(self, op_arrays, spec, N, npts, restrict, prolong,
                 labels=None):
        # ``op_arrays``: operator data flowing through shard_map —
        #   banded: offset-major band (win..., N...) with identity padding
        #   kron:   tuple per axis of tuple of distinct padded 1D bands
        #           (replicated; ``labels``[a][r] is the static sharing map)
        self.op_arrays = op_arrays
        self.spec = spec              # HaloSpec (pads = stencil pads)
        self.N = N
        self.npts = npts
        self.restrict = restrict      # tuple[DistTransfer1D] | None
        self.prolong = prolong        # tuple[DistTransfer1D] | None (from l+1)
        self.labels = labels          # kron only: static sharing structure


class DistributedMG:
    """Multilevel sharded multigrid solver (semantics ≡ MultigridSolver)."""

    def __init__(self, problem, num_levels: int,
                 mesh_shape: Tuple[int, ...],
                 cfg: CycleConfig = CycleConfig(), devices=None,
                 dist_levels: int | str = "auto", overlap: bool = True,
                 mixed: bool = False, operator: str = "banded",
                 mixed_residual: str = "f64", inner_cycles: int = 1):
        # ``overlap``: emit halo ppermutes independent of the interior SpMV
        # so XLA can overlap communication with compute (SURVEY.md §7.1.7);
        # results are equal to the non-overlapped path to f64 roundoff.
        # ``mixed``: sharded defect correction (SURVEY.md §7.2.1 composed
        # with configs 4/5): the V/W-cycle runs on an f32 cast of the
        # sharded hierarchy inside an f64 residual loop, with semantics
        # identical to the serial :class:`poms_tpu.mg.mixed.MixedPrecisionMG`
        # step.
        if num_levels < 2:
            raise ValueError("DistributedMG needs >= 2 levels")
        if mixed and problem.b.interior.dtype != jnp.dtype(jnp.float64):
            # check a MATERIALIZED array, not space metadata: with
            # jax_enable_x64 off, the space still *says* float64 while every
            # buffer silently truncated to f32 — the exact failure mode this
            # guard exists to reject
            raise ValueError(
                "mixed=True needs f64 buffers; got "
                f"{problem.b.interior.dtype} (is jax_enable_x64 set?)")
        if mixed_residual not in ("f64", "twofloat"):
            raise ValueError(f"mixed_residual={mixed_residual!r}")
        if mixed_residual == "twofloat" and operator != "kron":
            raise ValueError("mixed_residual='twofloat' needs the kron "
                             "operator (the dw residual exploits its "
                             "structure)")
        self.mixed_residual = mixed_residual if mixed else None
        # low-dtype V-cycles per outer correction, chained via the cheap
        # low-dtype error residual (mirrors mg/mixed.py::error_cycles)
        self.inner_cycles = max(1, int(inner_cycles))
        if cfg.smoother.kind not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(
                f"smoother {cfg.smoother.kind!r} is not distributed "
                "(gs_lex is sequential — SURVEY.md §7.2.2)")
        if operator not in ("banded", "kron"):
            raise ValueError(f"operator={operator!r}")
        from dataclasses import replace as _dc_replace

        from poms_tpu.mg.smoother import resolve_omega

        d = problem.dim
        p = problem.degree
        mesh_shape = tuple(mesh_shape) + (1,) * (d - len(mesh_shape))
        self.problem = problem
        self.operator = operator
        periodic_problem = hasattr(problem, "shift")   # PeriodicProblem
        if periodic_problem:
            from poms_tpu.models.periodic import build_periodic_hierarchy

            self.levels = build_periodic_hierarchy(problem, num_levels,
                                                   operator=operator)
        else:
            self.levels = build_hierarchy(problem, num_levels,
                                          operator=operator)
        cfg = _dc_replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                      self.levels[0].A))
        self.cfg = cfg
        self.overlap = overlap
        self.mixed = mixed
        from poms_tpu.mg.smoother import attach_spectral_estimates

        self.lams = attach_spectral_estimates(self.levels, cfg.smoother)
        self.names = _AXIS_NAMES[:d]
        devices = devices if devices is not None else jax.devices()
        ndev = math.prod(mesh_shape)
        if ndev > len(devices):
            raise ValueError(f"mesh {mesh_shape} needs {ndev} devices, "
                             f"have {len(devices)}")
        self.mesh = jax.make_mesh(mesh_shape, self.names,
                                  devices=devices[:ndev])
        self.mesh_shape = mesh_shape
        dtype = problem.space.dtype

        # ---- choose L_dist and padded sizes (N_l = 2 N_{l+1}) ----------
        npts_l = [lev.A.space.npts for lev in self.levels]
        n_el = problem.n_el
        n_el_l = [tuple(ne // (1 << l) for ne in n_el)
                  for l in range(num_levels)]
        max_dist = num_levels - 1 if dist_levels == "auto" else int(dist_levels)
        max_dist = max(1, min(max_dist, num_levels - 1))
        L = 1
        while L < max_dist:
            ok = True
            for a in range(d):
                m = mesh_shape[a]
                # candidate coarsest-dist padded size for chain of length L+1
                base = max(-(-npts_l[l][a] // (1 << (L - l)))
                           for l in range(L + 1))
                Nc = -(-base // m) * m
                n_loc_coarse = Nc // m
                # smoother pads + transfer halos need ~ (p + 2) points; the
                # transfer halo width is ~ p + 2 on the coarse side
                if n_loc_coarse < max(p, 1) + 2:
                    ok = False
            if not ok:
                break
            L += 1
        self.L_dist = L

        base_N = []
        for a in range(d):
            m = mesh_shape[a]
            base = max(-(-npts_l[l][a] // (1 << (self.L_dist - 1 - l)))
                       for l in range(self.L_dist))
            base_N.append(-(-base // m) * m)
        Ns = []
        for l in range(self.L_dist):
            Ns.append(tuple(b * (1 << (self.L_dist - 1 - l))
                            for b in base_N))

        # periodic dims tolerate NO grid padding: the wrap neighbor of the
        # last interior point must be the first interior point, and padded
        # identity rows would sit in between (VERDICT r2 missing #7 guard)
        for a in range(d):
            if problem.space.periodic[a]:
                bad = [(l, Ns[l][a], npts_l[l][a]) for l in range(self.L_dist)
                       if Ns[l][a] != npts_l[l][a]]
                if bad:
                    raise ValueError(
                        f"periodic dim {a}: grid sizes {bad} need padding to "
                        f"tile mesh axis {mesh_shape[a]}; choose a mesh that "
                        f"divides every distributed level's npts (or fewer "
                        f"dist_levels)")

        # ---- build distributed levels ----------------------------------
        self.dist: List[_DistLevel] = []
        for l in range(self.L_dist):
            lev = self.levels[l]
            sp = lev.A.space
            N = Ns[l]
            n_loc = tuple(N[a] // mesh_shape[a] for a in range(d))
            spec = HaloSpec.build(self.names, mesh_shape, n_loc, sp.pads,
                                  sp.periodic)
            labels = None
            if operator == "kron":
                labels = lev.A._band_labels()
                by_axis = []
                for a in range(d):
                    n_lab = max(labels[a]) + 1
                    distinct = [None] * n_lab
                    for r, term in enumerate(lev.A.terms):
                        distinct[labels[a][r]] = term[a]
                    by_axis.append(tuple(
                        jnp.asarray(pad_band_1d_identity(np.asarray(B),
                                                         N[a]), dtype)
                        for B in distinct))
                op_arrays = tuple(by_axis)
            else:
                op_arrays = jnp.asarray(
                    _pad_band_identity(np.asarray(lev.A.band_t), sp.npts, N,
                                       sp.pads), dtype)
            restrict = prolong = None
            if l + 1 < num_levels:
                if periodic_problem:
                    P1s = [prolongation_periodic_1d(n_el_l[l + 1][a], p)
                           for a in range(d)]
                else:
                    P1s = [prolongation_interior_1d(n_el_l[l + 1][a], p)
                           for a in range(d)]
                if l + 1 < self.L_dist:
                    N_c = Ns[l + 1]
                else:
                    # transfers into the replicated range are applied after
                    # gathering; no dist transfer needed
                    N_c = None
                if N_c is not None:
                    restrict = tuple(
                        build_dist_transfer(P1s[a].T, N_c[a], N[a],
                                            mesh_shape[a], dtype,
                                            periodic=sp.periodic[a])
                        for a in range(d))
                    prolong = tuple(
                        build_dist_transfer(P1s[a], N[a], N_c[a],
                                            mesh_shape[a], dtype,
                                            periodic=sp.periodic[a])
                        for a in range(d))
            self.dist.append(_DistLevel(op_arrays, spec, N, sp.npts,
                                        restrict, prolong, labels))

        # double-word split of the level-0 kron bands for the twofloat
        # sharded residual (hi padded with identity rows, lo with zeros —
        # identity is exactly representable so the dw invariant holds)
        self._bands_df0 = None
        if mixed and self.mixed_residual == "twofloat":
            from poms_tpu.ops.twofloat import split_f64

            A0 = self.levels[0].A
            labels0 = self.dist[0].labels
            N0 = self.dist[0].N
            by_axis_df = []
            for a in range(d):
                distinct = [None] * (max(labels0[a]) + 1)
                for r, term in enumerate(A0.terms):
                    distinct[labels0[a][r]] = term[a]
                row = []
                for B in distinct:
                    hi, lo = split_f64(jnp.asarray(B, jnp.float64))
                    hi = jnp.asarray(
                        pad_band_1d_identity(np.asarray(hi), N0[a]),
                        jnp.float32)
                    lo = jnp.pad(jnp.asarray(lo, jnp.float32),
                                 ((0, N0[a] - B.shape[0]), (0, 0)))
                    row.append((hi, lo))
                by_axis_df.append(tuple(row))
            self._bands_df0 = tuple(by_axis_df)

        self.npts = npts_l[0]
        self.N = Ns[0]
        self._grid_spec = P(*self.names)
        step, fmg_step = self._build_step()
        self._step_raw = step
        self._step = jax.jit(step)
        self._fmg = jax.jit(fmg_step) if fmg_step is not None else None

    # ------------------------------------------------------------------
    def _pad_global(self, arr_int) -> jnp.ndarray:
        arr = jnp.asarray(arr_int)
        return jnp.pad(arr, [(0, self.N[a] - self.npts[a])
                             for a in range(len(self.N))])

    # ------------------------------------------------------------------
    def _build_step(self):
        cfg = self.cfg
        names = self.names
        d = len(names)
        omega = cfg.smoother.omega
        kind = cfg.smoother.kind
        L_dist = self.L_dist
        dist_meta = self.dist           # static per-level metadata
        serial_tail = self.levels[L_dist:]   # replicated below L_dist
        # serial-side transfers from level L_dist-1 to L_dist happen on the
        # gathered (replicated) residual using the stock banded transfers
        tail_restrict = self.levels[L_dist - 1].restrict
        tail_prolong = self.levels[L_dist - 1].prolong
        npts_boundary = self.dist[L_dist - 1].npts
        N_boundary = self.dist[L_dist - 1].N

        lams = self.lams
        cheb_frac = cfg.smoother.cheb_fraction
        cheb_deg = cfg.smoother.cheb_degree
        overlap = self.overlap
        operator = self.operator
        labels_l = [lv.labels for lv in self.dist]

        def apply_A(lev_i, op_loc, x_loc):
            spec = dist_meta[lev_i].spec
            if operator == "kron":
                return dist_kron_apply(op_loc, labels_l[lev_i], x_loc, spec)
            return dist_spmv(op_loc, x_loc, spec, overlap)

        def diag_of(lev_i, op_loc):
            spec = dist_meta[lev_i].spec
            if operator == "kron":
                return dist_kron_diag(op_loc, labels_l[lev_i], spec)
            return op_loc[tuple(spec.pads)]

        def smooth(lev_i, op_loc, x_loc, b_loc):
            spec = dist_meta[lev_i].spec
            diag_loc = diag_of(lev_i, op_loc)
            if kind == "jacobi":
                Ax = apply_A(lev_i, op_loc, x_loc)
                return x_loc + omega * (b_loc - Ax) / diag_loc
            if kind == "chebyshev":
                lam_max = lams[lev_i]
                lam_min = lam_max / cheb_frac
                theta = 0.5 * (lam_max + lam_min)
                delta = 0.5 * (lam_max - lam_min)
                z = (b_loc - apply_A(lev_i, op_loc, x_loc)) / diag_loc
                dd = z / theta
                x_loc = x_loc + dd
                sigma = theta / delta
                rho = 1.0 / sigma
                for _ in range(cheb_deg - 1):
                    z = (b_loc - apply_A(lev_i, op_loc, x_loc)) / diag_loc
                    rho_new = 1.0 / (2.0 * sigma - rho)
                    dd = rho_new * rho * dd + (2.0 * rho_new / delta) * z
                    x_loc = x_loc + dd
                    rho = rho_new
                return x_loc
            # RB-GS with GLOBAL parity from the block offsets
            starts = local_starts(spec)
            if operator == "kron":
                # generic masked formulation — mirrors the serial kron
                # branch of mg/smoother.py::rbgs_step exactly
                from poms_tpu.mg.smoother import color_mask

                for color in (0, 1):
                    s = (apply_A(lev_i, op_loc, x_loc)
                         - diag_loc * x_loc)
                    gs = (b_loc - s) / diag_loc
                    mask = color_mask(spec.n_loc, color, starts)
                    x_loc = jnp.where(
                        mask, (1.0 - omega) * x_loc + omega * gs, x_loc)
                return x_loc
            # banded: one masked pass per color
            for color in (0, 1):
                x_pad = pad_and_exchange(x_loc, spec)
                x_loc = _ops.rbgs_color(op_loc, x_pad, b_loc, omega,
                                        color, spec.n_loc, spec.pads,
                                        starts)
            return x_loc

        def gather_full(x_loc, N, npts):
            full = x_loc
            for a, name in enumerate(names):
                full = jax.lax.all_gather(full, name, axis=a, tiled=True)
            return full[tuple(slice(0, n) for n in npts)]

        def scatter_local(x_int, N, n_loc):
            x_pad = jnp.pad(x_int, [(0, N[a] - x_int.shape[a])
                                    for a in range(d)])
            starts = []
            for a, name in enumerate(names):
                starts.append(jax.lax.axis_index(name) * n_loc[a])
            return jax.lax.dynamic_slice(x_pad, tuple(starts), n_loc)

        def vcycle_local(l, x_loc, b_loc, bands, transfers, tail, tail_tr):
            # all ARRAY data (bands, transfer tables, serial-tail levels)
            # flows through explicit shard_map args; only static metadata
            # (specs, sizes) is closed over.
            meta = dist_meta[l]
            band_loc = bands[l]
            for _ in range(cfg.nu1):
                x_loc = smooth(l, band_loc, x_loc, b_loc)
            r_loc = b_loc - apply_A(l, band_loc, x_loc)
            if l + 1 < L_dist:
                restr, prol = transfers[l]
                b_c = dist_apply_transfer(restr, r_loc, meta.spec.axes,
                                          names)
                x_c = jnp.zeros_like(b_c)
                for _ in range(cfg.gamma):
                    x_c = vcycle_local(l + 1, x_c, b_c, bands, transfers,
                                       tail, tail_tr)
                corr = dist_apply_transfer(prol, x_c,
                                           dist_meta[l + 1].spec.axes, names)
            else:
                # agglomerate: gather residual, run the serial tail cycle
                from poms_tpu.ops.transfer import apply_transfer

                t_restrict, t_prolong = tail_tr
                r_int = gather_full(r_loc, meta.N, meta.npts)
                b_c_int = apply_transfer(t_restrict, r_int)
                sp_c = tail[0].A.space
                b_c = StencilVector.from_interior(sp_c, b_c_int)
                x_c = StencilVector.zeros(sp_c)
                tail_lams = lams[L_dist:] if lams is not None else None
                for _ in range(cfg.gamma):
                    x_c = cycle(tail, 0, x_c, b_c, cfg, tail_lams)
                corr_int = apply_transfer(t_prolong, x_c.interior)
                corr = scatter_local(corr_int, meta.N, meta.spec.n_loc)
            x_loc = x_loc + corr
            for _ in range(cfg.nu2):
                x_loc = smooth(l, band_loc, x_loc, b_loc)
            return x_loc

        mixed = self.mixed
        inner_cycles = self.inner_cycles

        def error_cycles_local(r_lo, bands_lo, transfers, tail, tail_tr):
            """inner_cycles low-dtype V-cycles on the error equation
            (mg/mixed.py::error_cycles, sharded form): extra cycles chain
            through the cheap low-dtype residual — one operator apply, no
            high-precision norm between them."""
            e_lo = vcycle_local(0, jnp.zeros_like(r_lo), r_lo, bands_lo,
                                transfers, tail, tail_tr)
            for _ in range(inner_cycles - 1):
                d_lo = r_lo - apply_A(0, bands_lo[0], e_lo)
                e_lo = e_lo + vcycle_local(0, jnp.zeros_like(d_lo), d_lo,
                                           bands_lo, transfers, tail,
                                           tail_tr)
            return e_lo

        def body(x_loc, b_loc, bands, transfers, tail, tail_tr):
            x_loc = vcycle_local(0, x_loc, b_loc, bands, transfers, tail,
                                 tail_tr)
            spec0 = dist_meta[0].spec
            r_loc = b_loc - apply_A(0, bands[0], x_loc)
            rn = dist_norm2(r_loc, spec0)
            return x_loc, rn

        def fmg_body(b_loc, bands, transfers, tail, tail_tr):
            # nested iteration on the sharded hierarchy (VERDICT r2 ask #8):
            # restrict b down the distributed range, agglomerate, serial
            # FMG on the tail, prolong up with one cycle per level
            from poms_tpu.ops.transfer import apply_transfer

            meta_last = dist_meta[L_dist - 1]
            bs = [b_loc]
            for l in range(L_dist - 1):
                restr, _ = transfers[l]
                bs.append(dist_apply_transfer(restr, bs[-1],
                                              dist_meta[l].spec.axes, names))
            t_restrict, t_prolong = tail_tr
            r_int = gather_full(bs[-1], meta_last.N, meta_last.npts)
            b_tail_int = apply_transfer(t_restrict, r_int)
            sp_t = tail[0].A.space
            b_tail = StencilVector.from_interior(sp_t, b_tail_int)
            tail_lams = lams[L_dist:] if lams is not None else None
            x_t = fmg(tail, b_tail, cfg, lams=tail_lams)
            corr_int = apply_transfer(t_prolong, x_t.interior)
            x_loc = scatter_local(corr_int, meta_last.N,
                                  meta_last.spec.n_loc)
            for l in range(L_dist - 1, -1, -1):
                if l < L_dist - 1:
                    _, prol = transfers[l]
                    x_loc = dist_apply_transfer(
                        prol, x_loc, dist_meta[l + 1].spec.axes, names)
                x_loc = vcycle_local(l, x_loc, bs[l], bands, transfers,
                                     tail, tail_tr)
            spec0 = dist_meta[0].spec
            rn = dist_norm2(b_loc - apply_A(0, bands[0], x_loc), spec0)
            return x_loc, rn

        def body_mixed(x_loc, b_loc, bands, bands_lo, transfers, tail,
                       tail_tr):
            # sharded defect correction x ← x + E(b − A x): f64 residual,
            # f32 cycle on the residual scaled to O(1) — step-for-step
            # identical to mg/mixed.py::MixedPrecisionMG
            spec0 = dist_meta[0].spec
            r_loc = b_loc - apply_A(0, bands[0], x_loc)
            scale = dist_norm2(r_loc, spec0)
            safe = jnp.where(scale > 0, scale, 1.0)
            r_lo = (r_loc / safe).astype(jnp.float32)
            e_lo = error_cycles_local(r_lo, bands_lo, transfers, tail,
                                      tail_tr)
            x_loc = x_loc + e_lo.astype(x_loc.dtype) * safe
            r2 = b_loc - apply_A(0, bands[0], x_loc)
            rn = dist_norm2(r2, spec0)
            return x_loc, rn

        rep = P()
        if operator == "kron":
            # per-axis 1D bands are tiny — replicated (prefix specs)
            band_specs = [rep for _ in range(L_dist)]
        else:
            # offset-major bands: win dims (unsharded) lead, grid dims trail
            band_specs = [P(*((None,) * d + names)) for _ in range(L_dist)]
        bands = [lv.op_arrays for lv in self.dist]
        transfers = [(self.dist[l].restrict, self.dist[l].prolong)
                     for l in range(L_dist - 1)]
        tail_tr = (tail_restrict, tail_prolong)

        if mixed:
            from poms_tpu.mg.mixed import _cast_levels

            def cast32(leaf):
                if (hasattr(leaf, "dtype")
                        and jnp.issubdtype(leaf.dtype, jnp.floating)):
                    return leaf.astype(jnp.float32)
                return leaf

            bands_lo = jax.tree.map(cast32, bands)
            transfers = jax.tree.map(cast32, transfers)
            serial_tail = _cast_levels(serial_tail, jnp.float32)
            tail_tr = jax.tree.map(cast32, tail_tr)

            if self.mixed_residual == "twofloat":
                from poms_tpu.ops.twofloat import dw_add, two_prod

                bands_df0 = self._bands_df0
                lab0 = labels_l[0]
                spec0 = dist_meta[0].spec

                def body_mixed_tf(xh, xl, rh, rl, rn_prev, bh, bl,
                                  bands_lo, bands_df0, transfers, tail,
                                  tail_tr):
                    # sharded defect correction carried entirely in
                    # double-word f32: no f64 emulation in the loop.  The
                    # residual (rh, rl) and its norm are CARRIED between
                    # iterations (mirroring mg/mixed.py::step_tf) — the
                    # pre-round-5 body recomputed both at entry, doubling
                    # the dominant dist residual+norm cost per cycle.
                    safe32 = jnp.where(rn_prev > 0, rn_prev,
                                       1.0).astype(jnp.float32)
                    r_lo = rh / safe32
                    e_lo = error_cycles_local(r_lo, bands_lo, transfers,
                                              tail, tail_tr)
                    ch, cl = two_prod(e_lo, safe32)     # exact e·safe
                    xh, xl = dw_add(xh, xl, ch, cl)
                    rh, rl = dist_kron_residual_df(bands_df0, lab0, bh,
                                                   bl, xh, xl, spec0)
                    rn = dist_dw_norm2(rh, rl, spec0)
                    return xh, xl, rh, rl, rn

                smap = jax.shard_map(
                    body_mixed_tf, mesh=self.mesh,
                    in_specs=(self._grid_spec, self._grid_spec,
                              self._grid_spec, self._grid_spec, rep,
                              self._grid_spec, self._grid_spec,
                              band_specs, rep,
                              jax.tree.map(lambda _: rep, transfers),
                              jax.tree.map(lambda _: rep, serial_tail),
                              jax.tree.map(lambda _: rep, tail_tr)),
                    out_specs=(self._grid_spec, self._grid_spec,
                               self._grid_spec, self._grid_spec, rep))

                def step(xh_glob, xl_glob, rh_glob, rl_glob, rn_prev,
                         bh_glob, bl_glob):
                    return smap(xh_glob, xl_glob, rh_glob, rl_glob,
                                rn_prev, bh_glob, bl_glob,
                                bands_lo, bands_df0, transfers,
                                serial_tail, tail_tr)

                return step, None

            smap = jax.shard_map(
                body_mixed, mesh=self.mesh,
                in_specs=(self._grid_spec, self._grid_spec,
                          band_specs, band_specs,
                          jax.tree.map(lambda _: rep, transfers),
                          jax.tree.map(lambda _: rep, serial_tail),
                          jax.tree.map(lambda _: rep, tail_tr)),
                out_specs=(self._grid_spec, rep))

            def step(x_glob, b_glob):
                return smap(x_glob, b_glob, bands, bands_lo, transfers,
                            serial_tail, tail_tr)

            return step, None

        smap = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(self._grid_spec, self._grid_spec,
                      band_specs,
                      jax.tree.map(lambda _: rep, transfers),
                      jax.tree.map(lambda _: rep, serial_tail),
                      jax.tree.map(lambda _: rep, tail_tr)),
            out_specs=(self._grid_spec, rep))

        def step(x_glob, b_glob):
            return smap(x_glob, b_glob, bands, transfers, serial_tail,
                        tail_tr)

        smap_fmg = jax.shard_map(
            fmg_body, mesh=self.mesh,
            in_specs=(self._grid_spec,
                      band_specs,
                      jax.tree.map(lambda _: rep, transfers),
                      jax.tree.map(lambda _: rep, serial_tail),
                      jax.tree.map(lambda _: rep, tail_tr)),
            out_specs=(self._grid_spec, rep))

        def fmg_step(b_glob):
            return smap_fmg(b_glob, bands, transfers, serial_tail, tail_tr)

        return step, fmg_step

    # ------------------------------------------------------------------
    def step(self, x_glob: jnp.ndarray, b_glob: jnp.ndarray):
        """One cycle on padded global arrays; returns (x, ‖r‖)."""
        return self._step(x_glob, b_glob)

    def fmg_step(self, b_glob: jnp.ndarray):
        """One FMG (nested-iteration) pass on the padded global RHS;
        returns (x, ‖r‖) — typically used as the solve's initial guess."""
        if self._fmg is None:
            raise ValueError("FMG is not built for mixed=True (the mixed "
                             "scheme corrects from x=0 each outer step)")
        return self._fmg(b_glob)

    def _solve_twofloat(self, b, tol, maxiter) -> SolveResult:
        from poms_tpu.ops.twofloat import merge_f64, split_f64

        b_glob = self._pad_global(b.interior)
        bh, bl = split_f64(b_glob)
        xh = jnp.zeros_like(bh)
        xl = jnp.zeros_like(bl)
        rh, rl = bh, bl                         # r(x=0) = b, exactly
        rn_prev = jnp.linalg.norm(b.interior)   # first step's scale
        residuals = [float(rn_prev)]
        wall = []
        it, converged = 0, residuals[-1] <= tol
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            xh, xl, rh, rl, rn = self._step(xh, xl, rh, rl, rn_prev, bh,
                                            bl)
            rn_prev = rn
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
        x = StencilVector.from_interior(self.problem.space,
                                        self.unpad(merge_f64(xh, xl)))
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)

    def unpad(self, x_glob) -> np.ndarray:
        """Interior of a padded global array, copied to the host (eager
        slicing of a sharded array is restricted under sharding-in-types;
        the solve is over, so a host copy is fine)."""
        return np.asarray(x_glob)[tuple(slice(0, n) for n in self.npts)]

    def solve_compiled_global(self, b: StencilVector = None,
                              tol: float = 1e-10, maxiter: int = 50):
        """Fully-jitted sharded solve (``lax.while_loop`` around the
        shard_map step): one dispatch and one scalar fetch per solve,
        where :meth:`solve` syncs with the host once per cycle.  Works for
        both the plain and the mixed-twofloat configurations.

        Returns ``(x_glob, final_residual, iterations)`` with ``x_glob``
        the padded global iterate, still sharded over the mesh.
        """
        b = b if b is not None else self.problem.b
        step = self._step_raw
        # one cached runner with tol and maxiter as traced arguments: a
        # fresh jax.jit object per call would re-trace on every solve, and
        # a new tolerance would compile anew (see
        # mg/mixed.py::solve_compiled)
        run = getattr(self, "_compiled_runner", None)
        if run is None and self.mixed and (
                self.mixed_residual == "twofloat"):
            from poms_tpu.ops.twofloat import merge_f64, split_f64

            @jax.jit
            def run_tf(b_glob, b_int, tol, maxiter):
                bh, bl = split_f64(b_glob)
                xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
                # rn stays f64 in the carry (an O(1) scalar): an f32 carry
                # could flip the `rn > tol` test by ~6e-8 relative near tol
                # and desynchronize the iteration count from the host loop,
                # which compares in f64
                rn0 = jnp.linalg.norm(b_int)

                def cond(st):
                    return jnp.logical_and(st[4] > tol, st[5] < maxiter)

                def body(st):
                    xh, xl, rh, rl, rn_prev, it = st
                    xh, xl, rh, rl, rn = step(xh, xl, rh, rl, rn_prev,
                                              bh, bl)
                    return (xh, xl, rh, rl, rn.astype(rn0.dtype), it + 1)

                st = jax.lax.while_loop(
                    cond, body, (xh, xl, bh, bl, rn0, jnp.int32(0)))
                return merge_f64(st[0], st[1]), st[4], st[5]

            run = self._compiled_runner = run_tf
        elif run is None:
            @jax.jit
            def run_plain(b_glob, b_int, tol, maxiter):
                x0 = jnp.zeros_like(b_glob)
                rn0 = jnp.linalg.norm(b_int).astype(b_glob.dtype)

                def cond(st):
                    return jnp.logical_and(st[1] > tol, st[2] < maxiter)

                def body(st):
                    x, _, it = st
                    x, rn = step(x, b_glob)
                    return (x, rn.astype(b_glob.dtype), it + 1)

                return jax.lax.while_loop(cond, body,
                                          (x0, rn0, jnp.int32(0)))

            run = self._compiled_runner = run_plain
        return run(self._pad_global(b.interior), b.interior, tol, maxiter)

    def solve_compiled(self, b: StencilVector = None, tol: float = 1e-10,
                       maxiter: int = 50):
        """:meth:`solve_compiled_global`, with the iterate unpadded into a
        StencilVector.  Returns ``(x, final_residual, iterations)``;
        equivalence with the host loop is pinned by tests/test_dist.py /
        test_dist_kron.py.  ``solve`` stays the logging/history path.
        """
        x_glob, rn, it = self.solve_compiled_global(b, tol, maxiter)
        x = StencilVector.from_interior(self.problem.space,
                                        self.unpad(x_glob))
        return x, rn, it

    def solve(self, b: StencilVector = None, tol: float = 1e-10,
              maxiter: int = 50, use_fmg: bool = False) -> SolveResult:
        b = b if b is not None else self.problem.b
        if self.mixed and self.mixed_residual == "twofloat":
            if use_fmg:
                raise ValueError("use_fmg is not available for the mixed "
                                 "twofloat solve")
            return self._solve_twofloat(b, tol, maxiter)
        b_glob = self._pad_global(b.interior)
        if use_fmg:
            x_glob, rn0 = self.fmg_step(b_glob)
            residuals = [float(rn0)]
        else:
            x_glob = jnp.zeros_like(b_glob)
            residuals = [float(jnp.linalg.norm(b.interior))]
        wall = []
        it, converged = 0, residuals[-1] <= tol
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            x_glob, rn = self.step(x_glob, b_glob)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
        x = StencilVector.from_interior(self.problem.space,
                                        self.unpad(x_glob))
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)
