"""Flagship production solve: 3D Poisson to ‖r‖₂ ≤ 1e-10, fast path.

The configuration of the headline solves (compiled single-dispatch
solves; times in PERF.md) — dw-precision MG-PCG, and defect correction
with the Chebyshev window at fraction 32:

- Kronecker-sum operator (structure-exploiting: O(n) data, where the
  banded band of a 512³ cubic grid alone would take 370 GB)
- Chebyshev(4)-smoothed f32 V-cycles
- double-word f32 (EFT) outer recurrences — no f64 arithmetic in the
  iterate loop
- `solve_compiled`: the whole solve is ONE `lax.while_loop` dispatch

Run:  python examples/headline_solve.py [n_el] [degree] [solver]
      solver ∈ {dc, pcg}   (defect correction | dw-precision MG-PCG)

On CPU hosts this runs the same code paths in true f64/f32 (slow compile
for the EFT graphs on small hosts — see tests/conftest.py notes).
"""
import sys
import time


def main(n_el=64, degree=3, solver="dc"):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.models.poisson import l2_error_manufactured, poisson_problem

    levels = max(2, (n_el - 1).bit_length() - 2)
    print(f"3D Poisson n_el={n_el}^3 degree={degree} levels={levels} "
          f"solver={solver}")
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=jnp.float64)
    # window fractions: PCG is insensitive (16 kept); DC took fewer
    # cycles with 32 at ≥128³ in a sweep over 64³–512³
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig(
                          "chebyshev",
                          cheb_fraction=16.0 if solver == "pcg" else 32.0))
    if solver == "pcg":
        mg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg,
                                mixed=True, operator="kron",
                                precision="dw")
    else:
        mg = MixedPrecisionMG(prob, num_levels=levels, cfg=cfg,
                              operator="kron", residual="twofloat")
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=100)   # compile+warm
    jax.block_until_ready(x.interior)
    t0 = time.perf_counter()
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=100)
    jax.block_until_ready(x.interior)
    wall = time.perf_counter() - t0
    r = prob.b.interior - prob.A.dot(x).interior
    print(f"converged in {int(it)} iterations, wall {wall:.4f} s "
          f"({wall / max(int(it), 1) * 1e3:.2f} ms/iter)")
    print(f"‖r‖₂ = {float(rn):.3e} (true: "
          f"{float(jnp.linalg.norm(r)):.3e})")
    print(f"L2 error vs manufactured solution: "
          f"{l2_error_manufactured(prob, x):.3e}")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 64,
         int(args[1]) if len(args) > 1 else 3,
         args[2] if len(args) > 2 else "dc")
