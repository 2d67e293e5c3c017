"""chip_smoke.py's pieces on the CPU: the peak table, the compile-cache
rule, the reference residual, the refusal to run without a GPU, and every
phase at a tiny size (the card runs them at full size)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import chip_smoke  # noqa: E402
from poms_tpu.bench.roofline import sol_bandwidth  # noqa: E402
from poms_tpu.models.poisson import poisson_problem  # noqa: E402
from poms_tpu.utils import compile_cache  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


class _Device:
    def __init__(self, kind, platform="gpu"):
        self.device_kind = kind
        self.platform = platform


@pytest.mark.parametrize("kind,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0),
                                       ("NVIDIA H100 NVL", 3900.0)])
def test_peak_table_known_kinds(kind, gbps):
    assert sol_bandwidth(_Device(kind)) == gbps


def test_peak_table_unknown_kind_raises():
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        sol_bandwidth(jax.devices()[0])      # the CPU has no entry


def test_cache_dir_from_environment(tmp_path):
    env = {compile_cache.ENV_VAR: str(tmp_path)}
    assert compile_cache.compile_cache_dir(env) == str(tmp_path)


def test_cache_dir_default_is_fixed_and_ignored():
    d = compile_cache.compile_cache_dir({})
    assert d == os.path.join(REPO, ".jax_cache")
    assert d == compile_cache.compile_cache_dir({})
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_leaves_environment_dir_alone(monkeypatch,
                                                            tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        compile_cache.enable_compile_cache()


@pytest.mark.parametrize("operator", ["banded", "kron"])
def test_reference_residual(operator):
    prob = poisson_problem(3, 4, degree=2, operator=operator,
                           dtype=jnp.float64)
    b = np.asarray(prob.b.interior)
    assert chip_smoke.reference_residual(prob.A, np.zeros_like(b), b) == \
        pytest.approx(np.linalg.norm(b), rel=1e-14)
    csr = prob.A.tocsr()
    x = spla.spsolve(csr.tocsc(), b.ravel()).reshape(b.shape)
    want = np.linalg.norm(b.ravel() - csr @ x.ravel())
    got = chip_smoke.reference_residual(prob.A, x, b)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-15)
    assert got < 1e-12 * np.linalg.norm(b)


def test_reference_residual_refuses_low_precision_operator():
    prob = poisson_problem(2, 4, degree=2, dtype=jnp.float32)
    b = np.asarray(prob.b.interior)
    with pytest.raises(ValueError, match="f64"):
        chip_smoke.reference_residual(prob.A, b, b)


def test_refuses_to_run_without_gpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu([])
    chip_smoke.require_gpu([_Device("NVIDIA H100 80GB HBM3")])


def test_rel_maxdiff():
    assert chip_smoke.rel_maxdiff([1.0, 2.0], [1.0, 4.0]) == 0.5


def test_phase_spmv_tiny(capsys, monkeypatch):
    """The applies are checked for real; the timings are stubbed (the CPU
    has no entry in the peak table)."""
    from poms_tpu.bench import roofline

    def fake_bench(npts, degree, dtype, impl):
        return roofline.BenchResult(
            name=impl, dtype="float32", grid=npts, wall_s=1e-3,
            gbytes_per_s={"xlastream": 200.0}.get(impl, 100.0),
            gnnz_per_s=1.0, pct_sol=50.0)

    monkeypatch.setattr(roofline, "bench_spmv", fake_bench)
    monkeypatch.setattr(roofline, "sol_bandwidth", lambda: 200.0)
    f = chip_smoke.phase_spmv("cpu", n_el=4)
    assert f["banded_rel_err"] <= chip_smoke.SPMV_RTOL
    assert f["kron_rel_err"] <= chip_smoke.SPMV_RTOL
    assert f["banded_pct_stream"] == 50.0 and f["peak_gbps"] == 200.0
    assert f["card"] == "cpu" and '"phase": "spmv"' in capsys.readouterr().out


@pytest.mark.parametrize("precision", ["dw", "f64"])
def test_phase_pcg_tiny(precision):
    f = chip_smoke.phase_pcg("cpu", precision, n_el=8)
    assert f["reference_residual"] <= chip_smoke.REF_TOL
    assert f["iterations"] > 0
    assert f.get("b_split_rel_err", 0.0) <= chip_smoke.SPLIT_RTOL


def test_phase_twofloat_dc_tiny():
    f = chip_smoke.phase_kron_dc("cpu", "twofloat", n_el=8)
    assert f["reference_residual"] <= chip_smoke.REF_TOL
    assert f["b_split_rel_err"] <= chip_smoke.SPLIT_RTOL


def test_phase_kron_dc_f64_tiny():
    f = chip_smoke.phase_kron_dc("cpu", "f64", n_el=8)
    assert abs(f["solver_residual"] - f["reference_residual"]) <= \
        chip_smoke.RESIDUAL_ATOL


@pytest.mark.parametrize("rn,ref,ok", [
    (9.0e-11, 9.0e-11, True),
    (9.5e-11, 5.15e-10, False),       # a residual that misses part of b
    (9.49e-11, 9.76e-11, False),      # the same fault at 3 %
    (1e-10, 1.0000001e-10, True),     # rounding of the recomputation
    (1e-10, 1.054e-10, False),        # recomputed above tol
])
def test_check_solve_gates(rn, ref, ok):
    f = {"phase": "t", "solver_residual": rn, "reference_residual": ref}
    if ok:
        chip_smoke._check_solve(f)
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_solve(f)


def test_split_rel_err_sees_a_lost_low_word():
    from poms_tpu.ops.twofloat import split_f64

    b = jnp.linspace(0.1, 1.0, 64, dtype=jnp.float64)
    hi, lo = split_f64(b)
    assert chip_smoke.split_rel_err((hi, lo), b) <= chip_smoke.SPLIT_RTOL
    assert chip_smoke.split_rel_err((hi, jnp.zeros_like(lo)), b) > \
        chip_smoke.SPLIT_RTOL


def test_phase_banded_dc_tiny():
    f = chip_smoke.phase_banded_dc("cpu", n_el=8)
    assert f["banded_vs_kron_rel"] <= chip_smoke.AGREE_RTOL


def test_phase_sharded_tiny(monkeypatch):
    """Four of the suite's eight virtual CPU devices; one solve call in
    place of the timed pair (the CPU mesh's collectives are slow)."""
    monkeypatch.setattr(chip_smoke, "_timed",
                        lambda fn: (jax.block_until_ready(fn()), 0.0, 0.0))
    f = chip_smoke.phase_sharded("cpu", n_cards=4, n_el=8)
    assert f["shard_devices"] == 4
    assert f["sharded_vs_one_card_rel"] <= chip_smoke.AGREE_RTOL


@pytest.mark.parametrize("impl,nbytes", [
    # 343 band terms + x + y per point
    ("jnp", (343 + 2) * 9 * 10 * 11 * 4),
    # x + y per point, and the K and M bands of each axis (7 wide)
    ("kron", (2 * 9 * 10 * 11 + 2 * (9 + 10 + 11) * 7) * 4),
])
def test_bench_spmv_byte_count(monkeypatch, impl, nbytes):
    """The banded apply is charged its band; the kron apply only its
    compulsory traffic, never the band it does not read."""
    from poms_tpu.bench import roofline

    monkeypatch.setattr(roofline, "time_step_loop", lambda *a, **k: 1.0)
    monkeypatch.setattr(roofline, "sol_bandwidth", lambda: 1.0)
    r = roofline.bench_spmv((9, 10, 11), 3, jnp.float32, impl=impl)
    assert r.gbytes_per_s == pytest.approx(nbytes / 1e9, rel=1e-12)
    assert r.gnnz_per_s == pytest.approx(343 * 990 / 1e9, rel=1e-12)
