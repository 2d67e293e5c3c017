"""Headline-solve bench, PCG variant: dw-precision MG-preconditioned CG.

    python -m poms_tpu.bench.one_pcg <n_el> [degree] [tol] [precision]
"""
import json
import sys
import time


def main():
    from poms_tpu.bench.configs import PCG_CHEB_FRACTION

    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    tol = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-10
    precision = sys.argv[4] if len(sys.argv) > 4 else "dw"
    cheb_fraction = (float(sys.argv[5]) if len(sys.argv) > 5
                     else PCG_CHEB_FRACTION)
    cheb_degree = int(sys.argv[6]) if len(sys.argv) > 6 else 4
    low = sys.argv[7] if len(sys.argv) > 7 else "f32"  # f32 | bf16

    import jax

    jax.config.update("jax_enable_x64", True)
    from poms_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from poms_tpu.bench.configs import chebyshev_cycle
    from poms_tpu.bench.configs import num_levels as levels_for
    from poms_tpu.mg.mixed import MGPreconditionedCG
    from poms_tpu.models.poisson import poisson_problem

    num_levels = levels_for(n_el)
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=jnp.float64)
    cfg = chebyshev_cycle(cheb_fraction, cheb_degree)
    low_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[low]
    pcg = MGPreconditionedCG(prob, num_levels=num_levels, cfg=cfg,
                             mixed=True, operator="kron",
                             precision=precision, low_dtype=low_dtype)
    # big grids: free the f64 RHS and skip the result vector (see the
    # MixedPrecisionMG.solve_compiled docstring)
    kw = {}
    if n_el >= 384 and precision == "dw":
        from poms_tpu.ops.twofloat import split_f64_jit

        b_pair = split_f64_jit(prob.b.interior)
        jax.block_until_ready(b_pair[0])
        prob.b = None
        kw = {"b_pair": b_pair, "return_x": False}
    x, rn, it = pcg.solve_compiled(tol=tol, maxiter=100, **kw)
    jax.block_until_ready(rn)
    del x
    t0 = time.perf_counter()
    x, rn, it = pcg.solve_compiled(tol=tol, maxiter=100, **kw)
    jax.block_until_ready(rn)
    wall = time.perf_counter() - t0
    it = int(it)
    print("RESULT " + json.dumps({
        "name": (f"pcg3d_n{n_el}_p{degree}_to_{tol:g}_{precision}"
                 f"_cheb{cheb_degree}f{cheb_fraction:g}"
                 + ("" if low == "f32" else f"_{low}")),
        "converged": float(rn) <= tol,
        "iterations": it,
        "per_iter_s": wall / max(it, 1),
        "wall_to_tol_s": wall,
        "final_residual": float(rn),
        "grid": [n_el] * 3, "levels": num_levels}), flush=True)


if __name__ == "__main__":
    main()
