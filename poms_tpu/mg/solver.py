"""Multigrid solver driver: hierarchy setup, convergence loop, history.

SURVEY.md §3.1: ``solve`` iterates jitted cycles until ‖r‖ ≤ tol·‖b‖ (or an
absolute tol), recording the residual history — the printed histories are
the reference's comparison artifact [B:L5], so they are recorded
structurally here (cycle index, ‖r‖₂, ratio ρ, wall time) and can be
emitted as JSON lines via utils/logging.py.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp

from poms_tpu.core.vector import StencilVector
from poms_tpu.mg.cycles import CycleConfig, cycle, fmg
from poms_tpu.mg.hierarchy import Level, build_hierarchy
from poms_tpu.models.poisson import PoissonProblem

__all__ = ["MultigridSolver", "SolveResult"]


@dataclass
class SolveResult:
    x: StencilVector
    residuals: List[float]
    iterations: int
    converged: bool
    wall_times: List[float] = field(default_factory=list)

    @property
    def convergence_factors(self) -> List[float]:
        r = self.residuals
        return [r[i + 1] / r[i] for i in range(len(r) - 1) if r[i] > 0]


class MultigridSolver:
    """Geometric multigrid solver for tensor-product B-spline problems."""

    def __init__(self, problem: PoissonProblem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(), operator: str = "banded"):
        from dataclasses import replace as _dc_replace

        from poms_tpu.mg.smoother import (attach_spectral_estimates,
                                          resolve_omega)

        self.problem = problem
        self.levels: List[Level] = build_hierarchy(problem, num_levels,
                                                   operator=operator)
        cfg = _dc_replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                      self.levels[0].A))
        self.cfg = cfg
        self.lams = attach_spectral_estimates(self.levels, cfg.smoother)
        lams = self.lams

        def step(levels, x, b):
            x = cycle(levels, 0, x, b, cfg, lams)
            r = b - levels[0].A.dot(x)
            return x, r.norm()

        self._step = jax.jit(step)

        def fmg_start(levels, b):
            return fmg(levels, b, cfg, lams=lams)

        self._fmg = jax.jit(fmg_start)

    def solve(self, b: Optional[StencilVector] = None,
              x0: Optional[StencilVector] = None,
              tol: float = 1e-10, maxiter: int = 50,
              rtol: bool = False, use_fmg: bool = False,
              logger=None) -> SolveResult:
        """Iterate cycles to tolerance (host loop; each cycle is one jit call).

        ``tol`` is absolute on ‖r‖₂ by default (the reference's headline
        metric is ‖r‖ ≤ 1e-10 on 3D Poisson [B:L2]); with ``rtol=True`` it is
        relative to ‖b‖.
        """
        b = b if b is not None else self.problem.b
        space = self.levels[0].A.space
        if use_fmg:
            x = self._fmg(self.levels, b)
        elif x0 is None:
            x = StencilVector.zeros(space)
        else:
            x = x0
        r0 = (b - self.levels[0].A.dot(x)).norm()
        residuals = [float(r0)]
        wall = []
        target = tol * float(b.norm()) if rtol else tol
        converged = residuals[-1] <= target
        it = 0
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            x, rn = self._step(self.levels, x, b)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= target
            if logger is not None:
                logger.log_cycle(cycle=it, residual=rn,
                                 rho=rn / residuals[-2] if residuals[-2] else 0.0,
                                 wall_s=wall[-1])
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 50):
        """Fully-jitted solve (lax.while_loop) — no host sync per cycle.

        Returns (x, final_residual, iterations).  Used by the benchmark
        harness where per-cycle host round-trips would pollute timings.

        The jitted runner is cached per (tol, maxiter) — a fresh jax.jit
        closure per call would re-trace on EVERY solve.
        """
        b = b if b is not None else self.problem.b
        levels, cfg = self.levels, self.cfg
        space = levels[0].A.space
        key = (float(tol), int(maxiter))
        cache = getattr(self, "_compiled_runners", None)
        if cache is None:
            cache = self._compiled_runners = {}
        if key not in cache:
            lams = self.lams

            @jax.jit
            def run(levels, b):
                x0 = StencilVector.zeros(space)
                r0 = (b - levels[0].A.dot(x0)).norm()

                def cond(state):
                    _, rn, it = state
                    return jnp.logical_and(rn > tol, it < maxiter)

                def body(state):
                    x, _, it = state
                    x = cycle(levels, 0, x, b, cfg, lams)
                    rn = (b - levels[0].A.dot(x)).norm()
                    return x, rn, it + 1

                return jax.lax.while_loop(cond, body, (x0, r0, 0))

            cache[key] = run
        return cache[key](levels, b)
