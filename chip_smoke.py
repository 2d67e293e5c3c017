#!/usr/bin/env python
"""Run the production multigrid solvers once on an NVIDIA GPU and check them.

    python chip_smoke.py             # phases 1-5, one card
    python chip_smoke.py --cards 4   # the sharded solve on four cards, only

Phases (3D Poisson, cubic B-splines):

1. SpMV at 128³ f32: the banded apply (``StencilMatrix.dot``) and the
   Kronecker-sum apply against the banded apply in f64, and the banded
   apply's achieved GB/s against the card's published peak and a plain-XLA
   stream ceiling measured in the same process.
2. dw-PCG at 512³ (MG-preconditioned CG in double-word f32).
3. f64-PCG at 512³.
4. Two-float defect correction at 512³, and the same solve with the f64
   residual beside it.
5. Banded defect correction with the f64 residual at 128³, and its
   solution against the Kronecker-sum one.

With ``--cards 4``: sharded two-float defect correction at 256³ on a
(2, 2, 1) mesh, against the one-card solve of the same problem.

Every solve is checked with ‖b − A·x‖₂ recomputed by the plain f64
operator, never with the residual the solver used: the recomputed residual
must meet the tolerance up to the recomputation's rounding, and must agree
with the solver's own to RESIDUAL_ATOL.  The double-word phases also check
the split of b into its (hi, lo) f32 pair on the card.  Each phase prints one
JSON line; a failed check raises, so the exit code is non-zero.  The last
line is ``{"ok": true, "device": {...}}``.  Without a GPU the script exits
non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-10
# the solver's own tolerance, with slack for the recomputation's rounding
# (an f64 apply and norm: ~1e-14 relative)
REF_TOL = TOL * (1 + 1e-6)
# |solver's residual − recomputed residual|.  A recurrence residual (PCG)
# drifts from the true one by rounding of order u·‖b‖ per iteration:
# ~1e-16 for the double-word and f64 modes, at most 1e-6·TOL on the grids
# run here.  A solver residual that misses part of b − A·x shows as a gap
# of percents of TOL.
RESIDUAL_ATOL = 1e-4 * TOL
# |b − (hi + lo)| / |b| of the double-word split of b
SPLIT_RTOL = 2.0 ** -49
# f32 sums of 343 terms, taken in another order than the f64 reference
SPMV_RTOL = 1e-5
# Agreement of two solutions.  A residual of 1e-10 bounds the error of two
# solvers that round differently only up to 1/λmin(A) amplification (2.8e-8
# between banded and kron at 32³ already), so each pair is compared after
# solving both to AGREE_TOL.
AGREE_RTOL = 1e-8
AGREE_TOL = 1e-12
DEGREE = 3


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"cannot read the card's name and power limit "
                           f"from nvidia-smi: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return "; ".join(lines)


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU: no CPU fallback."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise RuntimeError(f"chip_smoke.py needs a GPU; JAX found "
                           f"platform {platform!r}")


def reference_residual(A64, x_int, b_int) -> float:
    """‖b − A·x‖₂ with the plain f64 operator (banded or Kronecker-sum)."""
    import jax.numpy as jnp

    from poms_tpu.core.vector import StencilVector

    if A64.space.dtype != jnp.dtype(jnp.float64):
        raise ValueError("the reference residual needs the f64 operator")
    x = StencilVector.from_interior(A64.space, jnp.asarray(x_int,
                                                           jnp.float64))
    r = jnp.asarray(b_int, jnp.float64) - A64.dot(x).interior
    return float(jnp.linalg.norm(r))


def rel_maxdiff(a, ref) -> float:
    """max|a − ref| / max|ref|."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _timed(fn):
    """(result, compile-plus-first-call s, warm s) of two calls of ``fn``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, t1 - t0, time.perf_counter() - t1


def _emit(card, **fields):
    fields["peak_bytes_in_use"] = peak_bytes()
    fields["card"] = card
    print(json.dumps(fields), flush=True)
    return fields


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def phase_spmv(card, n_el: int = 128):
    """Banded and kron f32 applies vs the banded f64 apply; GB/s."""
    import jax
    import jax.numpy as jnp

    from poms_tpu.core.matrix import StencilMatrix
    from poms_tpu.core.vector import StencilVector
    from poms_tpu.mg.hierarchy import _kron_operator_from_1d
    from poms_tpu.models.poisson import poisson_problem

    prob = poisson_problem(3, n_el, degree=DEGREE, dtype=jnp.float64)
    A64 = prob.A
    sp32 = A64.space.with_dtype(jnp.float32)
    A32 = StencilMatrix(sp32, band_t=A64.band_t.astype(jnp.float32))
    K32 = _kron_operator_from_1d([(s.K, s.M) for s in prob.splines], sp32)
    x64 = jax.random.normal(jax.random.PRNGKey(0), A64.space.npts,
                            jnp.float64)
    y64 = A64.dot(StencilVector.from_interior(A64.space, x64)).interior
    v32 = StencilVector.from_interior(sp32, x64.astype(jnp.float32))
    y_b, first_s, warm_s = _timed(lambda: A32.dot(v32).interior)
    y_k = K32.dot(v32).interior
    err_b, err_k = rel_maxdiff(y_b, y64), rel_maxdiff(y_k, y64)
    fields = dict(phase="spmv", grid=[n_el] * 3, npts=list(sp32.npts),
                  degree=DEGREE, precision="f32",
                  banded_rel_err=err_b, kron_rel_err=err_k,
                  compile_first_s=first_s, warm_s=warm_s)
    del A64, A32, y64, prob
    from poms_tpu.bench import roofline

    npts = sp32.npts
    banded = roofline.bench_spmv(npts, DEGREE, jnp.float32, impl="jnp")
    stream = roofline.bench_spmv(npts, DEGREE, jnp.float32, impl="xlastream")
    kron = roofline.bench_spmv(npts, DEGREE, jnp.float32, impl="kron")
    fields.update(
        peak_gbps=roofline.sol_bandwidth(),
        banded_apply_s=banded.wall_s, banded_gbps=banded.gbytes_per_s,
        banded_pct_peak=banded.pct_sol,
        stream_ceiling_gbps=stream.gbytes_per_s,
        banded_pct_stream=100.0 * banded.gbytes_per_s / stream.gbytes_per_s,
        kron_apply_s=kron.wall_s, kron_gnnz_per_s=kron.gnnz_per_s)
    out = _emit(card, **fields)
    _check(err_b <= SPMV_RTOL, f"banded f32 apply off by {err_b:.3e}")
    _check(err_k <= SPMV_RTOL, f"kron f32 apply off by {err_k:.3e}")
    return out


def _solve_fields(phase, n_el, precision, it, rn, ref, setup_s, first_s,
                  warm_s, **extra):
    return dict(phase=phase, grid=[n_el] * 3, degree=DEGREE,
                precision=precision, iterations=int(it),
                solver_residual=float(rn), reference_residual=ref,
                setup_s=setup_s, compile_first_s=first_s, warm_s=warm_s,
                **extra)


def _check_solve(f):
    rn, ref = f["solver_residual"], f["reference_residual"]
    _check(rn <= TOL, f"{f['phase']}: solver stopped at {rn:.3e}")
    _check(ref <= REF_TOL,
           f"{f['phase']}: recomputed residual {ref:.6e} > {REF_TOL:.6e}")
    _check(abs(rn - ref) <= RESIDUAL_ATOL,
           f"{f['phase']}: solver residual {rn:.6e} against recomputed "
           f"{ref:.6e}")


def split_rel_err(b_pair, b) -> float:
    """max|b − (hi + lo)| / max|b| of a double-word split of ``b``."""
    from poms_tpu.ops.twofloat import merge_f64

    return rel_maxdiff(merge_f64(*b_pair), b)


def _check_split(f):
    _check(f["b_split_rel_err"] <= SPLIT_RTOL,
           f"{f['phase']}: b split to (hi, lo) off by "
           f"{f['b_split_rel_err']:.3e}")


def phase_pcg(card, precision: str, n_el: int = 512):
    """MG-preconditioned CG (``precision`` 'dw' or 'f64'), kron operator,
    configured as in poms_tpu/bench/one_pcg.py."""
    import jax.numpy as jnp

    from poms_tpu.bench.configs import (PCG_CHEB_FRACTION, chebyshev_cycle,
                                        num_levels)
    from poms_tpu.mg.mixed import MGPreconditionedCG
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.ops.twofloat import split_f64_jit

    t0 = time.perf_counter()
    prob = poisson_problem(3, n_el, degree=DEGREE, operator="kron",
                           dtype=jnp.float64)
    pcg = MGPreconditionedCG(prob, num_levels=num_levels(n_el),
                             cfg=chebyshev_cycle(PCG_CHEB_FRACTION),
                             mixed=True, operator="kron",
                             precision=precision)
    extra = {}
    if precision == "dw":
        kw = {"b_pair": split_f64_jit(prob.b.interior), "return_x": True}
        extra["b_split_rel_err"] = split_rel_err(kw["b_pair"],
                                                 prob.b.interior)
    else:
        kw = {"b": prob.b}
    setup_s = time.perf_counter() - t0
    (x, rn, it), first_s, warm_s = _timed(
        lambda: pcg.solve_compiled(tol=TOL, maxiter=100, **kw))
    ref = reference_residual(prob.A, x.interior, prob.b.interior)
    f = _emit(card, **_solve_fields(f"pcg_{precision}", n_el, precision, it,
                                    rn, ref, setup_s, first_s, warm_s,
                                    **extra))
    if extra:
        _check_split(f)
    _check_solve(f)
    return f


def _dc(prob, n_el, operator, residual):
    from poms_tpu.bench.configs import (chebyshev_cycle, dc_cheb_fraction,
                                        num_levels)
    from poms_tpu.mg.mixed import MixedPrecisionMG

    return MixedPrecisionMG(prob, num_levels=num_levels(n_el),
                            cfg=chebyshev_cycle(dc_cheb_fraction(n_el)),
                            operator=operator, residual=residual)


def phase_kron_dc(card, residual: str, n_el: int = 512):
    """Defect correction on the kron operator with the ``residual`` mode
    ('twofloat' or 'f64'), configured as in poms_tpu/bench/one_solve.py."""
    import jax.numpy as jnp

    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.ops.twofloat import split_f64_jit

    t0 = time.perf_counter()
    prob = poisson_problem(3, n_el, degree=DEGREE, operator="kron",
                           dtype=jnp.float64)
    mg = _dc(prob, n_el, "kron", residual)
    extra = {}
    if residual == "twofloat":
        kw = {"b_pair": split_f64_jit(prob.b.interior), "return_x": True}
        extra["b_split_rel_err"] = split_rel_err(kw["b_pair"],
                                                 prob.b.interior)
    else:
        kw = {"b": prob.b}
    setup_s = time.perf_counter() - t0
    (x, rn, it), first_s, warm_s = _timed(
        lambda: mg.solve_compiled(tol=TOL, maxiter=100, **kw))
    ref = reference_residual(prob.A, x.interior, prob.b.interior)
    f = _emit(card, **_solve_fields(f"dc_{residual}", n_el, residual, it, rn,
                                    ref, setup_s, first_s, warm_s, **extra))
    if extra:
        _check_split(f)
    _check_solve(f)
    return f


def phase_banded_dc(card, n_el: int = 128):
    """Banded defect correction with the f64 residual, then its solution
    against the kron two-float one (both solved to AGREE_TOL)."""
    import jax.numpy as jnp

    from poms_tpu.models.poisson import poisson_problem

    t0 = time.perf_counter()
    prob = poisson_problem(3, n_el, degree=DEGREE, dtype=jnp.float64)
    mg = _dc(prob, n_el, "banded", "f64")
    setup_s = time.perf_counter() - t0
    (x, rn, it), first_s, warm_s = _timed(
        lambda: mg.solve_compiled(tol=TOL, maxiter=100))
    ref = reference_residual(prob.A, x.interior, prob.b.interior)
    x_b, rn_b, it_b = mg.solve_compiled(tol=AGREE_TOL, maxiter=300)
    x_b = np.asarray(x_b.interior)
    prob_k = poisson_problem(3, n_el, degree=DEGREE, operator="kron",
                             dtype=jnp.float64)
    x_k, rn_k, it_k = _dc(prob_k, n_el, "kron", "twofloat").solve_compiled(
        tol=AGREE_TOL, maxiter=300)
    agree = rel_maxdiff(x_b, x_k.interior)
    f = _emit(card, **_solve_fields(
        "dc_banded_f64", n_el, "f64", it, rn, ref, setup_s, first_s, warm_s,
        agree_tol=AGREE_TOL, agree_banded_residual=float(rn_b),
        agree_banded_iterations=int(it_b), agree_kron_residual=float(rn_k),
        agree_kron_iterations=int(it_k), banded_vs_kron_rel=agree))
    _check_solve(f)
    _check(agree <= AGREE_RTOL,
           f"banded and kron solutions differ by {agree:.3e}")
    return f


def phase_sharded(card, n_cards: int = 4, n_el: int = 256):
    """Sharded kron + two-float defect correction over ``n_cards`` devices
    against the one-card solve of the same problem (both also solved to
    AGREE_TOL for the comparison of the solutions)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _factor_mesh
    from poms_tpu.bench.configs import (chebyshev_cycle, dc_cheb_fraction,
                                        num_levels)
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.parallel.dist import DistributedMG

    devices = jax.devices()
    _check(len(devices) >= n_cards,
           f"need {n_cards} devices, found {len(devices)}")
    mesh_shape = _factor_mesh(n_cards, 3)
    t0 = time.perf_counter()
    prob = poisson_problem(3, n_el, degree=DEGREE, operator="kron",
                           dtype=jnp.float64)
    mg = DistributedMG(prob, num_levels=num_levels(n_el),
                       mesh_shape=mesh_shape,
                       cfg=chebyshev_cycle(dc_cheb_fraction(n_el)),
                       devices=devices[:n_cards], mixed=True,
                       operator="kron", mixed_residual="twofloat")
    setup_s = time.perf_counter() - t0
    (x_glob, rn, it), first_s, warm_s = _timed(
        lambda: mg.solve_compiled_global(tol=TOL, maxiter=100))
    shard_devices = x_glob.sharding.device_set
    x_int = mg.unpad(x_glob)
    ref = reference_residual(prob.A, x_int, prob.b.interior)
    one = _dc(prob, n_el, "kron", "twofloat")
    x_1, rn_1, it_1 = one.solve_compiled(tol=TOL, maxiter=100)
    agree_at_tol = rel_maxdiff(x_int, x_1.interior)
    x_a, rn_a, it_a = mg.solve_compiled_global(tol=AGREE_TOL, maxiter=300)
    x_1a, rn_1a, it_1a = one.solve_compiled(tol=AGREE_TOL, maxiter=300)
    agree = rel_maxdiff(mg.unpad(x_a), x_1a.interior)
    f = _solve_fields(
        "dc_twofloat_sharded", n_el, "twofloat", it, rn, ref, setup_s,
        first_s, warm_s, mesh=list(mesh_shape),
        dist_levels=mg.L_dist, shard_devices=len(shard_devices),
        one_card_iterations=int(it_1), one_card_residual=float(rn_1),
        sharded_vs_one_card_rel_at_tol=agree_at_tol, agree_tol=AGREE_TOL,
        agree_sharded_residual=float(rn_a),
        agree_sharded_iterations=int(it_a),
        agree_one_card_residual=float(rn_1a),
        agree_one_card_iterations=int(it_1a),
        sharded_vs_one_card_rel=agree,
        peak_bytes_per_card=[peak_bytes(d) for d in devices[:n_cards]])
    f = _emit(card, **f)
    _check_solve(f)
    _check(len(shard_devices) == n_cards,
           f"iterate sits on {len(shard_devices)} devices, not {n_cards}")
    _check(agree <= AGREE_RTOL,
           f"sharded and one-card solutions differ by {agree:.3e}")
    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded solve on four cards")
    args = ap.parse_args(argv)

    import os

    import jax

    jax.config.update("jax_enable_x64", True)
    from poms_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    require_gpu(devices)
    card = card_info()
    print(json.dumps({"card": card, "device_kind": devices[0].device_kind,
                      "jax": jax.__version__,
                      "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")}),
          flush=True)
    if args.cards == 4:
        phase_sharded(card, n_cards=4)
    else:
        phase_spmv(card)
        dw = phase_pcg(card, "dw")
        f64 = phase_pcg(card, "f64")
        _check(abs(dw["iterations"] - f64["iterations"]) <= 1,
               f"dw-PCG took {dw['iterations']} iterations, f64-PCG "
               f"{f64['iterations']}")
        phase_kron_dc(card, "twofloat")
        phase_kron_dc(card, "f64")
        phase_banded_dc(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
