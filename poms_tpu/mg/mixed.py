"""Mixed-precision solvers: defect correction and MG-preconditioned CG.

SURVEY.md §7.2.1: the tolerance target is ‖r‖ ≤ 1e-10 (f64 territory),
while f32 moves half the bytes of f64 through the memory-bound kernels.
Resolution, standard in mixed-precision linear algebra:

- **Defect correction** (iterative refinement):
      x ← x + E(b − A x)
  where the residual uses the f64 operator (one SpMV per outer step) or
  the double-word f32 residual, and the error solve E is a full V-cycle run
  entirely in f32 on a casted hierarchy.  The f32 cycle only ever sees the
  *residual* scaled to O(1), so its rounding floor does not limit the
  attainable residual.

- **Flexible PCG**: conjugate gradients in f64 with one f32 V-cycle as the
  preconditioner application (Polak–Ribière/IPCG form, which tolerates the
  slightly nonsymmetric f32 preconditioner).  Halves iteration counts for
  the slow-smoother regimes (high degree p).
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp

from poms_tpu.core.vector import StencilVector
from poms_tpu.mg.cycles import CycleConfig, cycle
from poms_tpu.mg.hierarchy import Level, build_hierarchy
from poms_tpu.mg.solver import SolveResult
from poms_tpu.models.poisson import PoissonProblem

__all__ = ["MixedPrecisionMG", "MGPreconditionedCG"]


def _cast_levels(levels, dtype):
    """Cast a hierarchy's arrays (bands, transfer weights, Cholesky factor)."""
    from poms_tpu.core.kron import KroneckerSumOperator

    def cast(leaf):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf.astype(dtype)
        return leaf

    lo = jax.tree.map(cast, levels)
    # spaces are static metadata; rebuild with the low dtype so that
    # from_interior casts stay consistent
    out = []
    for lev in lo:
        sp = lev.A.space.with_dtype(dtype)
        if hasattr(lev.A, "band_t"):
            A = type(lev.A)(sp, band_t=lev.A.band_t)
        else:  # KroneckerSumOperator
            A = KroneckerSumOperator(sp, lev.A.terms)
        out.append(Level(A=A, restrict=lev.restrict, prolong=lev.prolong,
                         chol=lev.chol))
    return out


class MixedPrecisionMG:
    """Defect-correction multigrid: high-precision residuals, f32 cycles.

    ``residual`` selects how the outer residual r = b − A·x is computed:

    - ``"f64"``      — jnp f64 (the default).
    - ``"twofloat"`` — double-word f32 via the EFT toolbox
                       (:mod:`poms_tpu.ops.twofloat`): the iterate, RHS and
                       residual are carried as (hi, lo) f32 pairs (~49
                       mantissa bits) and the Kronecker-structured residual
                       runs entirely in f32 arithmetic — no f64 anywhere in
                       the iterate loop.  Requires ``operator="kron"``.
                       On an H100, f64 is native and this mode is the
                       slower one where both were timed (PERF.md).
    """

    def __init__(self, problem: PoissonProblem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(),
                 low_dtype=jnp.float32, operator: str = "banded",
                 residual: str = "f64", inner_cycles: int = 1):
        # ``inner_cycles``: f32 V-cycles per outer correction, chained via
        # the CHEAP f32 residual of the error equation.  More than one has
        # not paid at the production config: the convergence tail is
        # limited by a ~0.8 worst-mode cycle factor that extra inner
        # smoothing squares without the tail following.
        if problem.space.dtype != jnp.dtype(jnp.float64):
            raise ValueError("build the problem in f64; the low-precision "
                             "hierarchy is derived from it")
        from dataclasses import replace as _dc_replace

        from poms_tpu.mg.smoother import (attach_spectral_estimates,
                                          resolve_omega)

        if residual not in ("f64", "twofloat"):
            raise ValueError(f"residual={residual!r}")
        if residual == "twofloat" and operator != "kron":
            raise ValueError("residual='twofloat' needs the Kronecker-sum "
                             "operator (structure the dw residual exploits)")
        self.residual_mode = residual
        self.inner_cycles = inner_cycles = max(1, int(inner_cycles))
        self.problem = problem
        if hasattr(problem, "shift"):   # PeriodicProblem (models/periodic)
            from poms_tpu.models.periodic import build_periodic_hierarchy

            self.levels64 = build_periodic_hierarchy(problem, num_levels,
                                                     operator=operator)
        else:
            self.levels64 = build_hierarchy(problem, num_levels,
                                            operator=operator)
        cfg = _dc_replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                      self.levels64[0].A))
        self.cfg = cfg
        lams = attach_spectral_estimates(self.levels64, cfg.smoother)
        self.levels32 = _cast_levels(self.levels64, low_dtype)
        self.low_dtype = low_dtype
        A64 = self.levels64[0].A
        sp32 = self.levels32[0].A.space

        def error_cycles(levels32, r32):
            """inner_cycles f32 V-cycles on the error equation, chained
            through the cheap f32 residual (one low-dtype operator apply
            per extra cycle — the outer high-precision residual/norm are
            NOT recomputed between inner cycles)."""
            e32 = cycle(levels32, 0, StencilVector.zeros(sp32), r32, cfg,
                        lams)
            for _ in range(inner_cycles - 1):
                d = StencilVector.from_interior(
                    sp32, r32.interior - levels32[0].A.dot(e32).interior)
                de = cycle(levels32, 0, StencilVector.zeros(sp32), d, cfg,
                           lams)
                e32 = StencilVector.from_interior(
                    sp32, e32.interior + de.interior)
            return e32

        def step(levels64, levels32, x, b):
            r = b - levels64[0].A.dot(x)           # f64 residual
            scale = r.norm()
            safe = jnp.where(scale > 0, scale, 1.0)
            r32 = StencilVector.from_interior(
                sp32, (r.interior / safe).astype(low_dtype))
            e32 = error_cycles(levels32, r32)
            e = e32.interior.astype(jnp.float64) * safe
            x = StencilVector.from_interior(x.space, x.interior + e)
            rn = (b - levels64[0].A.dot(x)).norm()
            return x, rn

        self._step_raw = step
        self._step = jax.jit(step)

        if residual == "twofloat":
            from poms_tpu.ops.twofloat import (dw_add, dw_norm2,
                                               residual_kron_df, split_f64,
                                               two_prod)

            # split each DISTINCT 1D band once so the sharing labels (static,
            # from the concrete f64 bands) stay valid for the split pairs
            labels = A64._band_labels()
            seen = {}
            terms_df = []
            for term in A64.terms:
                row = []
                for B in term:
                    key = id(B)
                    if key not in seen:
                        seen[key] = split_f64(
                            jnp.asarray(B, jnp.float64))
                    row.append(seen[key])
                terms_df.append(tuple(row))
            self._terms_df = tuple(terms_df)
            pads = problem.space.pads
            periodic = problem.space.periodic

            def step_tf(levels32, terms_df, xh, xl, rh, rl, bh, bl,
                        rn_prev):
                # one correction from the CURRENT residual, then the new
                # residual — everything except two O(1) scalar ops is f32
                # (or bf16 when low_dtype asks for it: the cycle runs in
                # the low dtype, the EFT bookkeeping stays f32).
                # ``rn_prev`` is ‖(rh, rl)‖ computed by the PREVIOUS step
                # (or dw_norm2(bh, bl) at start) — threading it in place of
                # an in-step dw_norm2 is numerically identical and saves
                # one full sum tree per outer iteration.
                safe32 = jnp.where(rn_prev > 0, rn_prev,
                                   1.0).astype(jnp.float32)
                r32 = StencilVector.from_interior(
                    sp32, (rh / safe32).astype(sp32.dtype))
                e32 = error_cycles(levels32, r32)
                ch, cl = two_prod(e32.interior.astype(jnp.float32),
                                  safe32)                 # exact e·safe
                xh, xl = dw_add(xh, xl, ch, cl)
                rh, rl = residual_kron_df(terms_df, bh, bl, xh, xl, pads,
                                          labels=labels, periodic=periodic)
                rn = dw_norm2(rh, rl)
                return xh, xl, rh, rl, rn

            self._step_tf_raw = step_tf
            self._step_tf = jax.jit(step_tf)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 100,
                       b_pair=None, return_x: bool = True):
        """Fully-jitted defect-correction solve (``lax.while_loop``):
        ONE dispatch + ONE scalar fetch per solve, vs one host sync per
        cycle in :meth:`solve`.

        Device-memory knobs for giant grids (twofloat mode only):
        ``b_pair=(bh, bl)`` supplies the pre-split RHS so the caller can
        FREE the f64 ``b`` before solving; ``return_x=False`` skips
        materializing the padded result vector (returns ``(x_interior,
        rn, it)`` with the raw f64 interior instead of a StencilVector).

        Returns ``(x, final_residual, iterations)``; equivalent to
        :meth:`solve` (same per-cycle update — pinned by
        tests/test_mixed.py::test_solve_compiled_matches_host_loop).
        ``solve`` stays the logging/history path.
        """
        space = self.problem.space
        # one jitted runner per mode, with tol and maxiter as traced
        # arguments: a fresh jax.jit object per call would re-trace on
        # EVERY solve, and a new tolerance would compile anew
        key = self.residual_mode
        cache = getattr(self, "_compiled_runners", None)
        if cache is None:
            cache = self._compiled_runners = {}
        if self.residual_mode == "twofloat":
            from poms_tpu.ops.twofloat import dw_norm2, merge_f64, split_f64

            step_tf = self._step_tf_raw
            # split OUTSIDE the jit and pass the (hi, lo) f32 pair: an
            # f64 b_int parameter costs 1.07 GB at 512³ plus the in-graph
            # split temps
            from poms_tpu.ops.twofloat import split_f64_jit

            if b_pair is not None:
                bh_e, bl_e = b_pair
            else:
                b = b if b is not None else self.problem.b
                bh_e, bl_e = split_f64_jit(b.interior)

            def wrap(x_int):
                return (StencilVector.from_interior(space, x_int)
                        if return_x else x_int)

            if key in cache:
                x_int, rn, it = cache[key](self.levels32, self._terms_df,
                                           bh_e, bl_e, tol, maxiter)
                return (wrap(x_int), rn, it)

            @jax.jit
            def run_tf(levels32, terms_df, bh, bl, tol, maxiter):
                xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
                rn0 = dw_norm2(bh, bl)

                def cond(st):
                    return jnp.logical_and(st[4] > tol, st[5] < maxiter)

                def body(st):
                    xh, xl, rh, rl, rn_prev, it = st
                    xh, xl, rh, rl, rn = step_tf(levels32, terms_df, xh, xl,
                                                 rh, rl, bh, bl, rn_prev)
                    return (xh, xl, rh, rl, rn, it + 1)

                st = jax.lax.while_loop(
                    cond, body, (xh, xl, bh, bl, rn0, jnp.int32(0)))
                return merge_f64(st[0], st[1]), st[4], st[5]

            cache[key] = run_tf
            x_int, rn, it = run_tf(self.levels32, self._terms_df, bh_e,
                                   bl_e, tol, maxiter)
            return wrap(x_int), rn, it

        b = b if b is not None else self.problem.b
        step = self._step_raw
        if key in cache:
            return cache[key](self.levels64, self.levels32, b, tol, maxiter)

        @jax.jit
        def run(levels64, levels32, b, tol, maxiter):
            x0 = StencilVector.zeros(space)
            rn0 = b.norm()

            def cond(st):
                return jnp.logical_and(st[1] > tol, st[2] < maxiter)

            def body(st):
                x, _, it = st
                x, rn = step(levels64, levels32, x, b)
                return (x, rn, it + 1)

            return jax.lax.while_loop(cond, body, (x0, rn0, jnp.int32(0)))

        cache[key] = run
        return run(self.levels64, self.levels32, b, tol, maxiter)

    def _solve_twofloat(self, b, tol, maxiter, logger):
        from poms_tpu.ops.twofloat import dw_norm2, merge_f64, split_f64

        bh, bl = split_f64(b.interior)
        xh = jnp.zeros_like(bh)
        xl = jnp.zeros_like(bl)
        rh, rl = bh, bl                       # r(x=0) = b, exactly
        rn_prev = jax.jit(dw_norm2)(bh, bl)   # the first step's scale
        residuals = [float(b.norm())]
        wall = []
        it, converged = 0, residuals[-1] <= tol
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            xh, xl, rh, rl, rn = self._step_tf(
                self.levels32, self._terms_df, xh, xl, rh, rl, bh, bl,
                rn_prev)
            rn_prev = rn
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
            if logger is not None:
                logger.log_cycle(cycle=it, residual=rn,
                                 rho=rn / residuals[-2] if residuals[-2]
                                 else 0.0, wall_s=wall[-1])
        x = StencilVector.from_interior(self.problem.space,
                                        merge_f64(xh, xl))
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)

    def solve(self, b: Optional[StencilVector] = None, tol: float = 1e-10,
              maxiter: int = 100, logger=None) -> SolveResult:
        b = b if b is not None else self.problem.b
        if self.residual_mode == "twofloat":
            return self._solve_twofloat(b, tol, maxiter, logger)
        x = StencilVector.zeros(self.problem.space)
        residuals = [float(b.norm())]
        wall = []
        it, converged = 0, residuals[-1] <= tol
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            x, rn = self._step(self.levels64, self.levels32, x, b)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
            if logger is not None:
                logger.log_cycle(cycle=it, residual=rn,
                                 rho=rn / residuals[-2] if residuals[-2]
                                 else 0.0, wall_s=wall[-1])
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)


class MGPreconditionedCG:
    """Flexible CG (IPCG) with one multigrid cycle as preconditioner.

    The Krylov acceleration wraps either the f64 hierarchy or the f32
    hierarchy in the mixed scheme (the fast path).
    """

    def __init__(self, problem: PoissonProblem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(), mixed: bool = True,
                 low_dtype=jnp.float32, operator: str = "banded",
                 precision: str = "f64"):
        # ``precision``: arithmetic of the OUTER Krylov recurrence —
        #   'f64' — classic: CG vectors/SpMV in f64.
        #   'dw'  — double-word f32 (requires operator='kron' + mixed):
        #          x, r carried as (hi, lo) f32 pairs, A·p through the EFT
        #          Kronecker apply, search directions and
        #          preconditioner in f32, α/β/ρ as O(1) f64 scalars.  The
        #          flexible (IPCG) β tolerates both the f32 preconditioner
        #          and the f32 directions; r/x keep ~49-bit recurrences so
        #          1e-10 is reachable.
        from dataclasses import replace as _dc_replace

        from poms_tpu.mg.smoother import (attach_spectral_estimates,
                                          resolve_omega)

        #   'dwrr' — dw with RESIDUAL REPLACEMENT (van der Vorst/Carson
        #          style, round-5 experiment): the working residual and
        #          A·p run in plain f32 (the dw A·p is flop-bound), and
        #          every ``replace_every`` iterations the TRUE residual is
        #          recomputed from x in
        #          double-word; the stopping test only ever sees the true
        #          dw residual, so the reported convergence is honest.
        #          x stays a dw pair (the correction α·p is accumulated
        #          exactly via two_prod).
        if precision not in ("f64", "dw", "dwrr"):
            raise ValueError(f"precision={precision!r}")
        if precision in ("dw", "dwrr") and operator != "kron":
            raise ValueError(f"precision={precision!r} needs the "
                             "Kronecker-sum operator (the EFT apply "
                             "exploits it)")
        self.precision = precision
        self.replace_every = 3

        self.problem = problem
        if hasattr(problem, "shift"):   # PeriodicProblem (models/periodic)
            from poms_tpu.models.periodic import build_periodic_hierarchy

            self.levels = build_periodic_hierarchy(problem, num_levels,
                                                   operator=operator)
        else:
            self.levels = build_hierarchy(problem, num_levels,
                                          operator=operator)
        cfg = _dc_replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                      self.levels[0].A))
        self.cfg = cfg
        lams = attach_spectral_estimates(self.levels, cfg.smoother)
        self.mixed = mixed and problem.space.dtype == jnp.dtype(jnp.float64)
        if precision in ("dw", "dwrr") and not self.mixed:
            # documented contract: dw carries (hi, lo) f32 pairs against a
            # low-precision preconditioner hierarchy; an f64 levels_pre
            # would silently mix dtypes in step_dw/precond_dw
            raise ValueError("precision=%r requires mixed=True and an "
                             "f64 problem (got mixed=%r, dtype=%s)"
                             % (precision, mixed, problem.space.dtype))
        self.levels_pre = (_cast_levels(self.levels, low_dtype)
                          if self.mixed else self.levels)
        self.low_dtype = low_dtype
        sp_pre = self.levels_pre[0].A.space

        def precond(levels_pre, r: StencilVector) -> StencilVector:
            scale = r.norm()
            safe = jnp.where(scale > 0, scale, 1.0)
            r_lo = StencilVector.from_interior(
                sp_pre, (r.interior / safe).astype(sp_pre.dtype))
            z_lo = cycle(levels_pre, 0, StencilVector.zeros(sp_pre), r_lo,
                         cfg, lams)
            z = z_lo.interior.astype(r.space.dtype) * safe
            return StencilVector.from_interior(r.space, z)

        def step(levels, levels_pre, x, r, z, p, rz):
            A = levels[0].A
            Ap = A.dot(p)
            alpha = rz / p.dot(Ap)
            x = x.axpy(alpha, p)
            r_new = r.axpy(-alpha, Ap)
            z_new = precond(levels_pre, r_new)
            # flexible (IPCG / Polak–Ribière) beta
            rz_new = r_new.dot(z_new)
            beta = (rz_new - r_new.dot(z)) / rz
            p = z_new.axpy(beta, p)
            return x, r_new, z_new, p, rz_new, r_new.norm()

        self._step_raw = step
        self._precond_raw = precond
        self._step = jax.jit(step)
        self._precond = jax.jit(precond)

        if precision in ("dw", "dwrr"):
            from poms_tpu.ops.twofloat import (dw_add, dw_dot, dw_dot_stack,
                                               dw_mul, dw_norm2,
                                               residual_kron_df, split_f64)

            A64 = self.levels[0].A
            labels = A64._band_labels()
            seen = {}
            terms_df = []
            for term in A64.terms:
                row = []
                for B in term:
                    key = id(B)
                    if key not in seen:
                        seen[key] = split_f64(jnp.asarray(B, jnp.float64))
                    row.append(seen[key])
                terms_df.append(tuple(row))
            self._terms_df = tuple(terms_df)
            pads = problem.space.pads

            periodic = problem.space.periodic

            def apply_A_dw(terms_df, ph):
                """A·p in double-word from an f32 direction p: the EFT
                kron residual with b = 0 gives −A·p."""
                z = jnp.zeros_like(ph)
                nh, nl = residual_kron_df(terms_df, z, z, ph, z, pads,
                                          labels=labels, periodic=periodic)
                return -nh, -nl

            def precond_dw(levels_pre, rh, rl, scale):
                """z ≈ M⁻¹ r from the dw residual: one f32 cycle on the
                unit-scaled hi word, rescaled back (f32 holds 1e-10-scale
                values fine; only the RATIO needs cycle accuracy).
                ``scale`` is ‖r‖ (= dw_norm2(rh, rl)) — passed in rather
                than recomputed because the step already needs that norm
                for convergence (one full sum tree saved per iteration)."""
                safe = jnp.where(scale > 0, scale, 1.0)
                r_hat = StencilVector.from_interior(
                    sp_pre, (rh / safe.astype(jnp.float32)))
                z_hat = cycle(levels_pre, 0, StencilVector.zeros(sp_pre),
                              r_hat, cfg, lams)
                return z_hat.interior * safe.astype(jnp.float32)

            def step_dw(levels_pre, terms_df, xh, xl, rh, rl, z, p, rz):
                # α = ρ / pᵀAp ;  x += αp ;  r −= αAp   (dw recurrences)
                aph, apl = apply_A_dw(terms_df, p)
                pAp = dw_dot(p, jnp.zeros_like(p), aph, apl)
                alpha = rz / pAp
                a_h, a_l = split_f64(alpha)
                dxh, dxl = dw_mul(a_h, a_l, p, jnp.zeros_like(p))
                xh, xl = dw_add(xh, xl, dxh, dxl)
                drh, drl = dw_mul(-a_h, -a_l, aph, apl)
                rh, rl = dw_add(rh, rl, drh, drl)
                rn = dw_norm2(rh, rl)      # convergence norm = precond scale
                z_new = precond_dw(levels_pre, rh, rl, rn)
                # ρ_new = z_newᵀ r_new and the flexible (IPCG)
                # β = z_newᵀ(r_new − r_old)/ρ_old, with r_new − r_old = −αAp
                # already in hand in dw — ONE batched sum tree for both dots
                # (tree levels are latency-bound; see dw_dot_stack)
                zz = jnp.zeros_like(z_new)
                rz_new, s = dw_dot_stack([(z_new, zz, rh, rl),
                                          (z_new, zz, drh, drl)])
                beta = s / rz
                p = z_new + beta.astype(jnp.float32) * p
                return xh, xl, rh, rl, z_new, p, rz_new, rn

            self._step_dw_raw = step_dw
            self._precond_dw_raw = precond_dw
            self._step_dw = jax.jit(step_dw)

            def step_dwrr(levels_pre, terms_df, xh, xl, rf, z, p, rz):
                """One 'dwrr' iteration: f32 working residual rf and f32
                A·p (the plain Kronecker apply — the dw apply is
                flop-bound at several times the cost); x stays dw via the
                exact two_prod(α, p) accumulation.  The true residual is
                restored by the caller's periodic dw replacement."""
                zz = jnp.zeros_like(p)
                ap = levels_pre[0].A._apply_interior(p)     # f32 A·p
                pAp = dw_dot(p, zz, ap, zz)
                alpha = rz / pAp
                a_h, a_l = split_f64(alpha)
                dxh, dxl = dw_mul(a_h, a_l, p, zz)
                xh, xl = dw_add(xh, xl, dxh, dxl)
                dr = -alpha.astype(jnp.float32) * ap
                rf = rf + dr
                rn_f = dw_norm2(rf, zz)         # approx norm → precond scale
                z_new = precond_dw(levels_pre, rf, zz, rn_f)
                rz_new, sdot = dw_dot_stack([(z_new, zz, rf, zz),
                                             (z_new, zz, dr, zz)])
                beta = sdot / rz
                p = z_new + beta.astype(jnp.float32) * p
                return xh, xl, rf, z_new, p, rz_new

            self._step_dwrr_raw = step_dwrr

    def _solve_dw(self, b, tol, maxiter, logger):
        import time as _time

        from poms_tpu.ops.twofloat import dw_dot, merge_f64, split_f64

        sp = self.problem.space
        bh, bl = split_f64(b.interior)
        xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
        rh, rl = bh, bl
        residuals = [float(b.norm())]
        if residuals[-1] <= tol:
            return SolveResult(x=StencilVector.zeros(sp),
                               residuals=residuals, iterations=0,
                               converged=True)
        # first z/p outside the step (same structure as the f64 loop)
        z = self._first_z(rh, rl)
        p = z
        rz = dw_dot(z, jnp.zeros_like(z), rh, rl)
        wall = []
        it, converged = 0, False
        while not converged and it < maxiter:
            t0 = _time.perf_counter()
            xh, xl, rh, rl, z, p, rz, rn = self._step_dw(
                self.levels_pre, self._terms_df, xh, xl, rh, rl, z, p, rz)
            rn = float(rn)
            wall.append(_time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
            if logger is not None:
                logger.log_cycle(cycle=it, residual=rn,
                                 rho=rn / residuals[-2], wall_s=wall[-1])
        x = StencilVector.from_interior(sp, merge_f64(xh, xl))
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)

    def _first_z(self, rh, rl):
        """Initial preconditioned residual for the dw loop (jitted once)."""
        if not hasattr(self, "_first_z_fn"):
            cfg = self.cfg
            sp_pre = self.levels_pre[0].A.space
            from poms_tpu.mg.smoother import attach_spectral_estimates

            lams = attach_spectral_estimates(self.levels, cfg.smoother)
            from poms_tpu.ops.twofloat import dw_norm2

            def f(levels_pre, rh, rl):
                scale = dw_norm2(rh, rl)
                safe = jnp.where(scale > 0, scale, 1.0)
                r_hat = StencilVector.from_interior(
                    sp_pre, rh / safe.astype(jnp.float32))
                z_hat = cycle(levels_pre, 0, StencilVector.zeros(sp_pre),
                              r_hat, cfg, lams)
                return z_hat.interior * safe.astype(jnp.float32)

            self._first_z_fn = jax.jit(f)
        return self._first_z_fn(self.levels_pre, rh, rl)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 100,
                       b_pair=None, return_x: bool = True):
        """Fully-jitted PCG solve (``lax.while_loop``) — one dispatch +
        one scalar fetch per solve.  Returns
        ``(x, final_residual, iterations)``.  Covers both precision
        modes.  ``b_pair``/``return_x``: device-memory knobs for giant
        grids, dw mode only — see MixedPrecisionMG.solve_compiled."""
        if b_pair is None:
            b = b if b is not None else self.problem.b
        key = self.precision   # one runner per mode; tol/maxiter traced
        if self.precision == "dwrr":
            return self._solve_compiled_dwrr(b, tol, maxiter, b_pair,
                                             return_x, key)
        cache = getattr(self, "_compiled_runners", None)
        if cache is None:
            cache = self._compiled_runners = {}
        if self.precision == "dw":
            from poms_tpu.ops.twofloat import (dw_dot, dw_norm2, merge_f64,
                                               split_f64)

            space = self.problem.space
            if key not in cache:
                step_dw = self._step_dw_raw
                precond_dw = self._precond_dw_raw

                @jax.jit
                def run_dw(levels_pre, terms_df, bh, bl, tol, maxiter):
                    # (bh, bl) split outside the jit — see run_tf note.
                    # z₀ (the first preconditioned residual) is computed
                    # IN-GRAPH, saving a separate _first_z dispatch and
                    # its host round-trips (identical arithmetic).
                    xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
                    rh, rl = bh, bl
                    rn0 = dw_norm2(rh, rl)
                    z0 = precond_dw(levels_pre, rh, rl, rn0)
                    rz0 = dw_dot(z0, jnp.zeros_like(z0), rh, rl)

                    def cond(st):
                        return jnp.logical_and(st[7] > tol,
                                               st[8] < maxiter)

                    def body(st):
                        xh, xl, rh, rl, z, p, rz, _, it = st
                        xh, xl, rh, rl, z, p, rz, rn = step_dw(
                            levels_pre, terms_df, xh, xl, rh, rl, z, p, rz)
                        return (xh, xl, rh, rl, z, p, rz, rn, it + 1)

                    st = jax.lax.while_loop(
                        cond, body,
                        (xh, xl, rh, rl, z0, z0, rz0, rn0, jnp.int32(0)))
                    return merge_f64(st[0], st[1]), st[7], st[8]

                cache[key] = run_dw
            from poms_tpu.ops.twofloat import split_f64_jit

            if b_pair is not None:
                bh, bl = b_pair
            else:
                bh, bl = split_f64_jit(b.interior)
            x_int, rn, it = cache[key](self.levels_pre, self._terms_df,
                                       bh, bl, tol, maxiter)
            x = (StencilVector.from_interior(space, x_int) if return_x
                 else x_int)
            return x, rn, it
        if key not in cache:
            step = self._step_raw
            precond = self._precond_raw
            space = self.problem.space

            @jax.jit
            def run(levels, levels_pre, b, tol, maxiter):
                x0 = StencilVector.zeros(space)
                r0 = b
                z0 = precond(levels_pre, r0)
                rz0 = r0.dot(z0)
                rn0 = r0.norm()

                def cond(st):
                    return jnp.logical_and(st[5] > tol, st[6] < maxiter)

                def body(st):
                    x, r, z, p, rz, _, it = st
                    x, r, z, p, rz, rn = step(levels, levels_pre, x, r, z,
                                              p, rz)
                    return (x, r, z, p, rz, rn, it + 1)

                st = jax.lax.while_loop(
                    cond, body, (x0, r0, z0, z0, rz0, rn0, jnp.int32(0)))
                return st[0], st[5], st[6]

            cache[key] = run
        return cache[key](self.levels, self.levels_pre, b, tol, maxiter)

    def _solve_compiled_dwrr(self, b, tol, maxiter, b_pair, return_x, key):
        """Compiled residual-replacement PCG: rounds of ``replace_every``
        f32 iterations, each round ending with a dw TRUE-residual
        recompute that feeds both the f32 working residual and the
        stopping test (so convergence is certified on the true residual;
        the iteration count quantizes to the round size)."""
        from poms_tpu.ops.twofloat import (dw_add, dw_dot, dw_mul, dw_norm2,
                                           merge_f64, residual_kron_df,
                                           split_f64, split_f64_jit)

        space = self.problem.space
        cache = getattr(self, "_compiled_runners", None)
        if cache is None:
            cache = self._compiled_runners = {}
        if key not in cache:
            step_dwrr = self._step_dwrr_raw
            precond_dw = self._precond_dw_raw
            K = int(self.replace_every)
            labels = self.levels[0].A._band_labels()
            pads = self.problem.space.pads
            periodic = self.problem.space.periodic

            @jax.jit
            def run_dwrr(levels_pre, terms_df, bh, bl, tol, maxiter):
                xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
                rf = bh                     # true residual hi word at x=0
                rn0 = dw_norm2(bh, bl)
                z0 = precond_dw(levels_pre, bh, bl, rn0)
                rz0 = dw_dot(z0, jnp.zeros_like(z0), bh, bl)

                def cond(st):
                    return jnp.logical_and(st[6] > tol, st[7] < maxiter)

                def round_body(st):
                    xh, xl, rf, z, p, rz, _, it = st

                    def inner(_, s):
                        return step_dwrr(levels_pre, terms_df, *s)

                    # K−1 cheap full steps on the f32 working residual
                    xh, xl, rf, z, p, rz = jax.lax.fori_loop(
                        0, K - 1, inner, (xh, xl, rf, z, p, rz))
                    # K-th step: x-update only, then the dw TRUE-residual
                    # replacement doubles as this step's preconditioner
                    # input — one precond per iteration exactly like the
                    # dw mode, no extra cycle for the restart.  Restarting
                    # (p = z) on the fresh residual is essential:
                    # carrying stale (z, p, rz) across the replacement
                    # breaks conjugacy (8→15 iters at 32³ measured);
                    # with the MG preconditioner contracting ~0.07/iter
                    # the restart momentum loss is small.
                    zz = jnp.zeros_like(p)
                    ap = levels_pre[0].A._apply_interior(p)
                    pAp = dw_dot(p, zz, ap, zz)
                    alpha = rz / pAp
                    a_h, a_l = split_f64(alpha)
                    dxh, dxl = dw_mul(a_h, a_l, p, zz)
                    xh, xl = dw_add(xh, xl, dxh, dxl)
                    rh, rl = residual_kron_df(terms_df, bh, bl, xh, xl,
                                              pads, labels=labels,
                                              periodic=periodic)
                    rn = dw_norm2(rh, rl)
                    z = precond_dw(levels_pre, rh, rl, rn)
                    rz = dw_dot(z, zz, rh, rl)
                    return (xh, xl, rh, z, z, rz, rn, it + K)

                st = jax.lax.while_loop(
                    cond, round_body,
                    (xh, xl, rf, z0, z0, rz0, rn0, jnp.int32(0)))
                return merge_f64(st[0], st[1]), st[6], st[7]

            cache[key] = run_dwrr
        if b_pair is not None:
            bh, bl = b_pair
        else:
            bh, bl = split_f64_jit(b.interior)
        x_int, rn, it = cache[key](self.levels_pre, self._terms_df, bh, bl,
                                   tol, maxiter)
        x = (StencilVector.from_interior(space, x_int) if return_x
             else x_int)
        return x, rn, it

    def solve(self, b: Optional[StencilVector] = None, tol: float = 1e-10,
              maxiter: int = 100, logger=None) -> SolveResult:
        b = b if b is not None else self.problem.b
        if self.precision == "dwrr":
            # host-loop history is a dw/dwrr-mode concern the compiled
            # path covers; synthesize the result from one compiled solve
            x, rn, it = self.solve_compiled(b, tol=tol, maxiter=maxiter)
            rn = float(rn)
            return SolveResult(x=x, residuals=[float(b.norm()), rn],
                               iterations=int(it), converged=rn <= tol)
        if self.precision == "dw":
            return self._solve_dw(b, tol, maxiter, logger)
        A = self.levels[0].A
        x = StencilVector.zeros(self.problem.space)
        r = b
        residuals = [float(r.norm())]
        if residuals[-1] <= tol:
            return SolveResult(x=x, residuals=residuals, iterations=0,
                               converged=True)
        z = self._precond(self.levels_pre, r)
        p = z
        rz = r.dot(z)
        wall = []
        it, converged = 0, False
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            x, r, z, p, rz, rn = self._step(self.levels, self.levels_pre,
                                            x, r, z, p, rz)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
            if logger is not None:
                logger.log_cycle(cycle=it, residual=rn,
                                 rho=rn / residuals[-2], wall_s=wall[-1])
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)
