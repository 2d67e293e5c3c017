"""Mixed-precision defect correction + MG-PCG (SURVEY.md §7.2.1)."""
import numpy as np
import pytest

from poms_tpu.mg.cycles import CycleConfig
from poms_tpu.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu.mg.smoother import SmootherConfig
from poms_tpu.mg.solver import MultigridSolver
from poms_tpu.models.poisson import l2_error_manufactured, poisson_problem


def _cfg(omega=0.8):
    return CycleConfig(smoother=SmootherConfig("jacobi", omega))


def test_mixed_precision_reaches_1e10():
    """f32 cycles + f64 residuals must still reach the 1e-10 target."""
    prob = poisson_problem(2, 32, degree=3)
    mg = MixedPrecisionMG(prob, num_levels=3, cfg=_cfg())
    res = mg.solve(tol=1e-10, maxiter=100)
    assert res.converged, res.residuals[-5:]
    # true f64 residual check (recompute independently)
    r = prob.b - prob.A.dot(res.x)
    assert float(r.norm()) <= 2e-10


def test_mixed_tracks_f64_until_f32_floor():
    """Early cycles of the mixed scheme match the all-f64 solver closely."""
    prob = poisson_problem(1, 64, degree=3)
    f64 = MultigridSolver(prob, num_levels=2, cfg=_cfg(2 / 3))
    mixed = MixedPrecisionMG(prob, num_levels=2, cfg=_cfg(2 / 3))
    r_f64 = f64.solve(tol=1e-10, maxiter=8).residuals
    r_mix = mixed.solve(tol=1e-10, maxiter=8).residuals
    # the f32 error-cycle perturbs each residual at its own rounding level,
    # so compare convergence *rates*, not values
    for a, b in zip(r_f64[:5], r_mix[:5]):
        assert abs(a - b) / a < 0.1


def test_pcg_accelerates_slow_smoother():
    """MG-PCG needs fewer iterations than plain V-cycles (p=3 regime)."""
    prob = poisson_problem(2, 32, degree=3)
    plain = MultigridSolver(prob, num_levels=3, cfg=_cfg())
    pcg = MGPreconditionedCG(prob, num_levels=3, cfg=_cfg(), mixed=False)
    res_plain = plain.solve(tol=1e-10, maxiter=100)
    res_pcg = pcg.solve(tol=1e-10, maxiter=100)
    assert res_pcg.converged
    assert res_pcg.iterations < res_plain.iterations
    r = prob.b - prob.A.dot(res_pcg.x)
    assert float(r.norm()) <= 2e-10


def test_pcg_mixed_precision():
    prob = poisson_problem(2, 16, degree=2)
    pcg = MGPreconditionedCG(prob, num_levels=2, cfg=_cfg(), mixed=True)
    res = pcg.solve(tol=1e-10, maxiter=100)
    assert res.converged
    r = prob.b - prob.A.dot(res.x)
    assert float(r.norm()) <= 2e-10


def test_mixed_solution_accuracy():
    prob = poisson_problem(2, 32, degree=3)
    mg = MixedPrecisionMG(prob, num_levels=3, cfg=_cfg())
    res = mg.solve(tol=1e-10, maxiter=100)
    err = l2_error_manufactured(prob, res.x, pts_per_dim=64)
    assert err < 1e-6  # discretization-limited, not precision-limited


def test_mixed_precision_kron_operator():
    """Mixed defect correction over a Kronecker hierarchy reaches 1e-10."""
    prob = poisson_problem(2, 32, degree=3, operator="kron")
    from poms_tpu.mg.smoother import SmootherConfig as SC
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SC("chebyshev", cheb_fraction=16.0))
    mg = MixedPrecisionMG(prob, num_levels=3, cfg=cfg, operator="kron")
    res = mg.solve(tol=1e-10, maxiter=60)
    assert res.converged
    r = prob.b - prob.A.dot(res.x)
    assert float(r.norm()) <= 2e-10


def test_twofloat_residual_reaches_1e10():
    """Double-word-f32 outer residual (no f64 emulation in the loop) must
    converge to the same 1e-10 target as the f64 residual path."""
    prob = poisson_problem(2, 32, degree=3, operator="kron")
    from poms_tpu.mg.smoother import SmootherConfig as SC
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SC("chebyshev", cheb_fraction=16.0))
    mg = MixedPrecisionMG(prob, num_levels=3, cfg=cfg, operator="kron",
                          residual="twofloat")
    assert mg.residual_mode == "twofloat"
    res = mg.solve(tol=1e-10, maxiter=60)
    assert res.converged, res.residuals[-5:]
    # independent f64 residual of the merged solution
    r = prob.b - prob.A.dot(res.x)
    assert float(r.norm()) <= 2e-10


def test_twofloat_matches_f64_path():
    """Residual histories of the dw-f32 and f64 outer loops agree closely
    (the dw representation carries ~49 bits: ample for 1e-10)."""
    prob = poisson_problem(2, 16, degree=2, operator="kron")
    from poms_tpu.mg.smoother import SmootherConfig as SC
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SC("chebyshev", cheb_fraction=16.0))
    r_f64 = MixedPrecisionMG(prob, num_levels=2, cfg=cfg, operator="kron",
                             residual="f64").solve(tol=1e-10,
                                                   maxiter=40).residuals
    r_tf = MixedPrecisionMG(prob, num_levels=2, cfg=cfg, operator="kron",
                            residual="twofloat").solve(tol=1e-10,
                                                       maxiter=40).residuals
    for a, b in zip(r_f64[:8], r_tf[:8]):
        assert abs(a - b) / a < 0.05, (a, b)


def test_twofloat_auto_and_guard():
    prob = poisson_problem(1, 16, degree=2, operator="kron")
    mg = MixedPrecisionMG(prob, num_levels=2, operator="kron")
    assert mg.residual_mode == "f64"    # the default, kron included
    mg_b = MixedPrecisionMG(poisson_problem(1, 16, degree=2), num_levels=2)
    assert mg_b.residual_mode == "f64"
    with pytest.raises(ValueError):
        MixedPrecisionMG(prob, num_levels=2, operator="kron",
                         residual="auto")
    with pytest.raises(ValueError):
        MixedPrecisionMG(poisson_problem(1, 16, degree=2), num_levels=2,
                         residual="twofloat")


def test_solve_compiled_matches_host_loop():
    """solve_compiled (lax.while_loop, one dispatch) ≡ solve (host loop) —
    same iteration count, same solution, tolerance reached (VERDICT r3
    ask #4)."""
    prob = poisson_problem(2, 16, degree=2, operator="kron")
    cfg = _cfg()
    mg = MixedPrecisionMG(prob, num_levels=2, cfg=cfg, operator="kron",
                          residual="twofloat")
    res = mg.solve(tol=1e-10, maxiter=60)
    assert res.converged
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=60)
    assert int(it) == res.iterations
    assert float(rn) <= 1e-10
    np.testing.assert_allclose(np.asarray(x.interior),
                               np.asarray(res.x.interior),
                               rtol=0, atol=1e-13)


def test_solve_compiled_f64_mode():
    prob = poisson_problem(2, 16, degree=2)
    mg = MixedPrecisionMG(prob, num_levels=2, cfg=_cfg())
    res = mg.solve(tol=1e-10, maxiter=60)
    assert res.converged
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=60)
    assert int(it) == res.iterations
    assert float(rn) <= 1e-10
    np.testing.assert_allclose(np.asarray(x.interior),
                               np.asarray(res.x.interior),
                               rtol=0, atol=1e-13)


def test_bf16_inner_cycles_still_reach_1e10():
    """bf16 smoother/cycle hierarchy inside the twofloat defect correction
    (VERDICT r3 ask #6): the outer loop absorbs the inner-precision loss —
    convergence to 1e-10 holds on configs 1-3, with a bounded iteration
    penalty vs the f32 hierarchy."""
    import jax.numpy as jnp

    from poms_tpu.mg.smoother import SmootherConfig

    for dim, n_el, p in [(1, 64, 3), (2, 32, 3), (3, 16, 2)]:
        prob = poisson_problem(dim, n_el, degree=p, operator="kron")
        cfg = CycleConfig(nu1=1, nu2=1,
                          smoother=SmootherConfig("chebyshev",
                                                  cheb_fraction=16.0))
        its = {}
        for lo in (jnp.float32, jnp.bfloat16):
            mg = MixedPrecisionMG(prob, num_levels=2, cfg=cfg,
                                  operator="kron", residual="twofloat",
                                  low_dtype=lo)
            res = mg.solve(tol=1e-10, maxiter=100)
            assert res.converged, (dim, lo, res.residuals[-3:])
            its[lo] = res.iterations
        # measured this round: 7 -> 9/10; gate at 2x to stay robust
        assert its[jnp.bfloat16] <= 2 * its[jnp.float32], its


def test_pcg_solve_compiled_matches_host_loop():
    prob = poisson_problem(2, 16, degree=2)
    pcg = MGPreconditionedCG(prob, num_levels=2, cfg=_cfg())
    res = pcg.solve(tol=1e-10, maxiter=60)
    assert res.converged
    x, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=60)
    assert int(it) == res.iterations
    assert float(rn) <= 1e-10
    np.testing.assert_allclose(np.asarray(x.interior),
                               np.asarray(res.x.interior),
                               rtol=0, atol=1e-12)


def test_inner_cycles_converges_faster_per_outer_iter():
    """inner_cycles=2 chains two f32 V-cycles per outer correction via the
    cheap f32 error residual: fewer outer (high-precision) iterations for
    the same tolerance, identical final accuracy."""
    prob = poisson_problem(2, 32, degree=3, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0))
    r1 = MixedPrecisionMG(prob, num_levels=3, cfg=cfg, operator="kron",
                          residual="twofloat").solve(tol=1e-10, maxiter=60)
    r2 = MixedPrecisionMG(prob, num_levels=3, cfg=cfg, operator="kron",
                          residual="twofloat",
                          inner_cycles=2).solve(tol=1e-10, maxiter=60)
    assert r1.converged and r2.converged
    assert r2.iterations < r1.iterations, (r1.iterations, r2.iterations)


@pytest.mark.slow  # XLA:CPU compiles the deep EFT Krylov graph in ~90 s
def test_pcg_dw_precision_reaches_1e10():
    """dw-precision flexible PCG (EFT Krylov recurrences, f32 directions,
    no f64 emulation in the vector ops) reaches 1e-10 with a true
    residual to match.

    Host-loop, dw leg only on CPU (the f64 PCG leg is covered by the
    other PCG tests): XLA:CPU compiles the fused residual+dot EFT graphs
    in minutes, pathologically longer for the generic jacobi-on-kron
    smoother branch.  The compiled while_loop variant and the
    f64-iteration-parity comparison run on the card in chip_smoke.py
    (phases 2 and 3)."""
    import jax.numpy as jnp

    prob = poisson_problem(3, 32, degree=3, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0))
    dw = MGPreconditionedCG(prob, num_levels=3, cfg=cfg, mixed=True,
                            operator="kron", precision="dw")
    rdw = dw.solve(tol=1e-10, maxiter=60)
    assert rdw.converged
    assert rdw.iterations <= 12, rdw.iterations
    rr = prob.b.interior - prob.A.dot(rdw.x).interior
    assert float(jnp.linalg.norm(rr)) <= 5e-10





def test_pcg_dwrr_converges_to_true_tolerance():
    """Residual-replacement PCG (precision='dwrr', round-5 experiment):
    converges with the stopping test certified on the TRUE dw residual.
    Kept opt-in: it took 15 iterations where dw takes 9 at 128³, because
    each replacement restart forfeits CG's superlinearity; on the H100 it
    is not measured."""
    import jax.numpy as jnp

    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.mixed import MGPreconditionedCG
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.models.poisson import poisson_problem

    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0))
    prob = poisson_problem(3, 16, degree=3, operator="kron",
                           dtype=jnp.float64)
    rr = MGPreconditionedCG(prob, num_levels=2, cfg=cfg, mixed=True,
                            operator="kron", precision="dwrr")
    x, rn, it = rr.solve_compiled(tol=1e-10, maxiter=60)
    true_rn = float((prob.b - prob.A.dot(x)).norm())
    assert float(rn) <= 1e-10
    assert true_rn <= 2e-10
    assert int(it) % rr.replace_every == 0   # round-quantized count
