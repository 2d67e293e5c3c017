"""Solver configurations shared by the benchmark runners and chip_smoke.py.

The production 3D solves run Chebyshev-smoothed f32 V-cycles, one pre-
and one post-smoothing step, over a hierarchy whose coarsest grid has
about 8 elements per dimension.
"""
from __future__ import annotations

from poms_tpu.mg.cycles import CycleConfig
from poms_tpu.mg.smoother import SmootherConfig

__all__ = ["num_levels", "chebyshev_cycle", "dc_cheb_fraction",
           "PCG_CHEB_FRACTION"]

# Chebyshev window of the PCG preconditioner cycle: [λmax/16, λmax].
PCG_CHEB_FRACTION = 16.0


def num_levels(n_el: int) -> int:
    """Levels for an n_el³ grid: coarsen until ~8 elements per dimension."""
    return max(2, (n_el - 1).bit_length() - 2)


def dc_cheb_fraction(n_el: int) -> float:
    """Defect correction's Chebyshev window: 16 below 128³, 32 from it on
    (the window that took the fewest cycles in a sweep over 64³–512³)."""
    return 32.0 if n_el >= 128 else 16.0


def chebyshev_cycle(cheb_fraction: float, cheb_degree: int = 4) -> CycleConfig:
    return CycleConfig(nu1=1, nu2=1,
                       smoother=SmootherConfig("chebyshev",
                                               cheb_fraction=cheb_fraction,
                                               cheb_degree=cheb_degree))
