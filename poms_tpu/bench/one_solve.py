"""Headline-metric benchmark: V-cycle wall time to ‖r‖ ≤ 1e-10, 3D Poisson.

BASELINE.json:2 primary metric 2.  Runs the production mixed-precision
configuration
— Kronecker-sum operator, Chebyshev-smoothed f32 cycles inside the
defect-correction loop (mg/mixed.py) — as one isolated process printing a
single RESULT line:

    python -m poms_tpu.bench.one_solve <n_el> [degree] [tol] [residual]

``residual``: ``f64`` (the default) or ``twofloat``: both modes
measured with identical accounting in the same harness.

Two timings are reported per run:

- ``per_iter_s`` / ``wall_to_tol_s``: the COMPILED solve
  (``solve_compiled`` — ``lax.while_loop``, one dispatch + one scalar
  fetch for the whole solve).  This is the production number.
- ``host_loop_per_iter_s``: the host-loop per-iteration median, which
  includes one host sync per cycle.
"""
import json
import os
import sys
import time


def main():
    from poms_tpu.bench.configs import dc_cheb_fraction

    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    tol = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-10
    residual = sys.argv[4] if len(sys.argv) > 4 else "f64"
    inner = int(sys.argv[5]) if len(sys.argv) > 5 else 1
    cheb_fraction = (float(sys.argv[6]) if len(sys.argv) > 6
                     else dc_cheb_fraction(n_el))
    cheb_degree = int(sys.argv[7]) if len(sys.argv) > 7 else 4
    low = sys.argv[8] if len(sys.argv) > 8 else "f32"  # f32 | bf16

    import jax

    jax.config.update("jax_enable_x64", True)
    from poms_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from poms_tpu.bench.configs import chebyshev_cycle
    from poms_tpu.bench.configs import num_levels as levels_for
    from poms_tpu.mg.mixed import MixedPrecisionMG
    from poms_tpu.models.poisson import poisson_problem

    num_levels = levels_for(n_el)
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=jnp.float64)
    cfg = chebyshev_cycle(cheb_fraction, cheb_degree)
    low_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[low]
    mg = MixedPrecisionMG(prob, num_levels=num_levels, cfg=cfg,
                          operator="kron", residual=residual,
                          inner_cycles=inner, low_dtype=low_dtype)
    # host loop: residual history + convergence verification + the
    # per-iter median (includes one host sync per cycle).  Skipped at
    # 512³: the host loop's live (xh, xl, rh, rl) references double-book
    # device memory against the compiled solve's own state, and the
    # compiled path asserts convergence on its own.
    skip_host = n_el >= 384 or os.environ.get("POMS_SKIP_HOST_LOOP")
    if skip_host:
        host_per_iter, host_conv, host_iters = None, True, None
    else:
        res = mg.solve(tol=tol, maxiter=100)
        steady = res.wall_times[1:] or res.wall_times
        host_per_iter = float(np.median(steady))
        host_conv, host_iters = bool(res.converged), res.iterations

    # compiled solve: warm once (compile), then time the second call —
    # the deterministic solve re-runs the same iterations from x = 0.
    # Big grids free the f64 RHS first and skip the result vector (see
    # the solve_compiled docstring).
    kw = {}
    if skip_host and mg.residual_mode == "twofloat":
        from poms_tpu.ops.twofloat import split_f64_jit

        b_pair = split_f64_jit(prob.b.interior)
        jax.block_until_ready(b_pair[0])
        prob.b = None            # frees the padded f64 RHS (~1.1 GB @512³)
        kw = {"b_pair": b_pair, "return_x": False}
    x, rn, it = mg.solve_compiled(tol=tol, maxiter=100, **kw)
    jax.block_until_ready(rn)
    del x
    t0 = time.perf_counter()
    x, rn, it = mg.solve_compiled(tol=tol, maxiter=100, **kw)
    jax.block_until_ready(rn)
    wall = time.perf_counter() - t0
    it = int(it)
    per_iter = wall / max(it, 1)
    print("RESULT " + json.dumps({
        "name": (f"vcycle3d_n{n_el}_p{degree}_to_{tol:g}_"
                 f"{mg.residual_mode}_ic{inner}"
                 f"_cheb{cheb_degree}f{cheb_fraction:g}"
                 + ("" if low == "f32" else f"_{low}")),
        "converged": host_conv and float(rn) <= tol,
        "iterations": it,
        "per_iter_s": per_iter,
        "wall_to_tol_s": wall,
        "host_loop_per_iter_s": host_per_iter,
        "host_loop_iterations": host_iters,
        "final_residual": float(rn),
        "residual_mode": mg.residual_mode,
        "grid": [n_el] * 3, "levels": num_levels}), flush=True)


if __name__ == "__main__":
    main()
