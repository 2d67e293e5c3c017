"""Attribute the per-iteration cost of the mixed-precision solves.

VERDICT r3 ask #3 (defect correction) + r4 missing #6 (PCG): time each
component of the production iteration as a chained device loop with K/2K
differencing (bench/roofline.py timing rules).

Defect-correction components (mg/mixed.py::step_tf):

  - cycle   : one f32 (or bf16) V-cycle on the cast hierarchy
  - resid   : double-word Kronecker residual (ops/twofloat.py)
  - norm    : double-word pairwise-tree norm
  - step    : the full fused outer step (sanity: ≈ cycle+resid+norm)

PCG components (mg/mixed.py::step_dw):

  - cycle   : the preconditioner V-cycle
  - dw_ap   : A·p through the EFT Kronecker apply
  - dw_dot  : one dw dot (sum tree) — ×2 batched per iteration + pAp + rn
  - axpy    : the dw x/r recurrence updates
  - step    : the full fused PCG step

    python -m poms_tpu.bench.attr_iter <n_el> [degree] [dc|pcg]
"""
import json
import sys


def main():
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    what = sys.argv[3] if len(sys.argv) > 3 else "dc"

    import jax

    jax.config.update("jax_enable_x64", True)
    from poms_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from poms_tpu.bench.roofline import time_step_loop
    from poms_tpu.core.vector import StencilVector
    from poms_tpu.mg.cycles import CycleConfig, cycle
    from poms_tpu.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
    from poms_tpu.mg.smoother import SmootherConfig, attach_spectral_estimates
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.ops.twofloat import (dw_add, dw_mul, dw_norm2,
                                       residual_kron_df, split_f64)

    num_levels = max(2, (n_el - 1).bit_length() - 2)
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=jnp.float64)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0))
    out = {"n_el": n_el, "degree": degree, "levels": num_levels,
           "what": what}

    if what == "pcg":
        pcg = MGPreconditionedCG(prob, num_levels=num_levels, cfg=cfg,
                                 mixed=True, operator="kron",
                                 precision="dw")
        sp32 = pcg.levels_pre[0].A.space
        bh, bl = split_f64(prob.b.interior)
        labels = pcg.levels[0].A._band_labels()
        pads = prob.space.pads
        lams = attach_spectral_estimates(pcg.levels, cfg.smoother)

        def t_cycle(r32_int, *cs):
            v = StencilVector.from_interior(sp32, r32_int)
            e = cycle(pcg.levels_pre, 0, StencilVector.zeros(sp32), v, cfg,
                      lams)
            return e.interior

        out["cycle_s"] = time_step_loop(t_cycle, bh, iters=10)

        def t_ap(ph, *cs):
            z = jnp.zeros_like(ph)
            nh, nl = residual_kron_df(pcg._terms_df, z, z, ph, z, pads,
                                      labels=labels,
                                      periodic=prob.space.periodic)
            return -nh

        out["dw_ap_s"] = time_step_loop(t_ap, bh, iters=10)

        def t_dot(rh, *cs):
            n = dw_norm2(rh, jnp.zeros_like(rh))
            return rh * (1.0 + 0.0 * n.astype(rh.dtype))

        out["dw_dot_s"] = time_step_loop(t_dot, bh, iters=10)

        def t_axpy(carry, *cs):
            xh, xl = carry
            a_h = jnp.float32(0.5)
            dxh, dxl = dw_mul(a_h, jnp.float32(0.0), xh, xl)
            return dw_add(xh, xl, dxh, dxl)

        z0 = jnp.zeros_like(bh)
        out["axpy_s"] = time_step_loop(t_axpy, (bh, z0), iters=10)

        def t_step(carry, *cs):
            xh, xl, rh, rl, z, p, rz = carry
            xh, xl, rh, rl, z, p, rz, rn = pcg._step_dw_raw(
                pcg.levels_pre, pcg._terms_df, xh, xl, rh, rl, z, p, rz)
            return (xh, xl, rh, rl, z, p, rz)

        rz0 = jnp.float64(1.0)
        out["step_s"] = time_step_loop(
            t_step, (z0, z0, bh, bl, bh, bh, rz0), iters=10)
        print("RESULT " + json.dumps(out), flush=True)
        return

    mg = MixedPrecisionMG(prob, num_levels=num_levels, cfg=cfg,
                          operator="kron", residual="twofloat")
    sp32 = mg.levels32[0].A.space
    bh, bl = split_f64(prob.b.interior)
    labels = mg.levels64[0].A._band_labels()
    pads = prob.space.pads
    lams = attach_spectral_estimates(mg.levels64, cfg.smoother)

    def t_cycle(r32_int, *cs):
        v = StencilVector.from_interior(sp32, r32_int)
        e = cycle(mg.levels32, 0, StencilVector.zeros(sp32), v, cfg, lams)
        return e.interior

    out["cycle_s"] = time_step_loop(t_cycle, bh, iters=10)

    def t_resid(xh, *cs):
        rh, rl = residual_kron_df(mg._terms_df, bh, bl, xh,
                                  jnp.zeros_like(xh), pads, labels=labels)
        return rh

    out["resid_s"] = time_step_loop(t_resid, bh, iters=10)

    def t_norm(rh, *cs):
        n = dw_norm2(rh, jnp.zeros_like(rh))
        return rh * (1.0 + 0.0 * n.astype(rh.dtype))

    out["norm_s"] = time_step_loop(t_norm, bh, iters=10)

    def t_step(carry, *cs):
        xh, xl, rh, rl, rn = carry
        xh, xl, rh, rl, rn = mg._step_tf_raw(mg.levels32, mg._terms_df,
                                             xh, xl, rh, rl, bh, bl, rn)
        return (xh, xl, rh, rl, rn)

    z = jnp.zeros_like(bh)
    rn0 = jnp.float64(1.0)
    out["step_s"] = time_step_loop(t_step, (z, z, bh, bl, rn0), iters=10)
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
