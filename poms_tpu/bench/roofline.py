"""Roofline benchmark harness: achieved GB/s and nnz/s vs speed-of-light.

SURVEY.md §5.1: every hot kernel is profiled against the device-memory
roofline.  Banded stencil SpMV streams the band coefficients once
((2p+1)^d × 4B per grid point — the dominant term for d ≥ 2), reads x and
writes y, so

    bytes = (band_terms + 2) * grid_points * dtype_size       (+ O(halo))
    nnz   = band_terms * grid_points

Timing methodology: kernels are timed as K *chained* iterations inside one
jitted ``lax.fori_loop`` (one dispatch + one scalar fetch per
measurement), and two runs with K and 2K iterations are differenced to
cancel the fixed dispatch and fetch overhead.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sol_bandwidth", "bench_spmv", "bench_vcycle", "BenchResult",
           "time_step_loop"]

# Published device-memory bandwidth (GB/s), keyed by JAX's ``device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet — H100 SXM (80 GB HBM3)
# 3.35 TB/s, H100 PCIe (80 GB HBM2e) 2 TB/s, H100 NVL (94 GB HBM3)
# 3.9 TB/s.
_PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}


def sol_bandwidth(device=None) -> float:
    """Published memory bandwidth (GB/s) of ``device`` (default: the first).

    A device kind missing from the table is an error, never a default: a
    roofline share divided by another card's peak is a wrong number.
    """
    device = device or jax.devices()[0]
    kind = device.device_kind
    if kind not in _PEAK_HBM_GBPS:
        raise ValueError(f"no published memory bandwidth for device kind "
                         f"{kind!r}; add it to _PEAK_HBM_GBPS with its "
                         "source")
    return _PEAK_HBM_GBPS[kind]


@dataclass
class BenchResult:
    name: str
    dtype: str
    grid: tuple
    wall_s: float
    gbytes_per_s: float
    gnnz_per_s: float
    pct_sol: float

    def row(self) -> str:
        return (f"{self.name:28s} {self.dtype:8s} {str(self.grid):>18s} "
                f"{self.wall_s * 1e3:8.3f} ms "
                f"{self.gbytes_per_s:8.1f} GB/s {self.gnnz_per_s:8.2f} Gnnz/s "
                f"{self.pct_sol:6.1f} %SoL")


def time_step_loop(step, x0, consts=(), iters: int = 20) -> float:
    """Seconds per application of ``step`` (x -> x, same shape/dtype).

    Runs ``lax.fori_loop`` with K and 2K chained steps in single jit calls;
    returns (t_2K − t_K)/K.  ``consts`` are loop-invariant arrays (streamed
    every iteration, e.g. the band).
    """
    from functools import partial

    @partial(jax.jit, static_argnames=("n",))
    def run(x, n, *cs):
        return jax.lax.fori_loop(0, n, lambda i, xx: step(xx, *cs), x)

    def fetch(out):
        leaf = jax.tree.leaves(out)[0]
        return float(jnp.sum(leaf))     # one scalar fetch forces completion

    fetch(run(x0, iters, *consts))      # compile + warm
    fetch(run(x0, 2 * iters, *consts))
    best_k = best_2k = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fetch(run(x0, iters, *consts))
        best_k = min(best_k, time.perf_counter() - t0)
        t0 = time.perf_counter()
        fetch(run(x0, 2 * iters, *consts))
        best_2k = min(best_2k, time.perf_counter() - t0)
    # When the difference drowns in timing noise (tiny kernels), fall back
    # to the 2K run's per-iteration time, which is an upper bound.
    diff = (best_2k - best_k) / iters
    floor = 0.25 * best_2k / (2 * iters)
    return diff if diff > floor else best_2k / (2 * iters)


def bench_spmv(npts, degree: int = 3, dtype=jnp.float32, iters: int = 20,
               impl: str = "jnp") -> BenchResult:
    """Benchmark banded stencil SpMV on random (contracting) band data.

    ``impl``: ``jnp`` (the banded apply), ``kron`` (the Kronecker-sum
    apply of the same widths), ``xlastream`` (plain-XLA multiply-reduce
    over the banded apply's traffic: the measured copy ceiling) or
    ``xlastreamrw`` (elementwise read+write over a band-sized array).

    The step chains y = A·x back into the next input (re-padded with zero
    ghosts), so K iterations are data-dependent on device.  The band is
    scaled to be contracting so chained values decay instead of overflowing.
    """
    d = len(npts)
    npts = tuple(npts)
    pads = (degree,) * d
    band_shape = tuple(2 * degree + 1 for _ in range(d))
    terms = math.prod(band_shape)
    if impl == "kron":
        # structure-exploiting operator: random 1D bands with the same
        # widths as the Poisson Kronecker sum; 'nnz' counts the equivalent
        # banded operator (same matrix action, O(n) data instead of the
        # (2p+1)^d-per-point band).  Bytes are its compulsory traffic —
        # x read, y written, the 1D bands — not the band's: the partial
        # products between axes are not counted, so GB/s and the share of
        # peak are lower bounds.
        from poms_tpu.core.kron import KroneckerSumOperator
        from poms_tpu.core.space import StencilVectorSpace

        space = StencilVectorSpace(npts=npts, pads=pads, periodic=False,
                                   dtype=dtype)
        rng = np.random.default_rng(1)
        scale = 1.0 / (2.0 * (2 * degree + 1))
        Ks = [jnp.asarray(rng.standard_normal((n, 2 * degree + 1)) * scale,
                          dtype) for n in npts]
        Ms = [jnp.asarray(rng.standard_normal((n, 2 * degree + 1)) * scale,
                          dtype) for n in npts]
        kron_terms = [[Ks[b] if b == a else Ms[b] for b in range(d)]
                      for a in range(d)]
        op = KroneckerSumOperator(space, kron_terms)

        def step(x_int, *cs):
            return op._apply_interior(x_int)

        x0i = jnp.full(npts, 1e-3, dtype)
        wall = time_step_loop(step, x0i, iters=iters)
    elif impl == "xlastreamrw":
        # Elementwise read+WRITE stream over a band-sized array (x' = ax+b
        # chained through the carry): measures the aggregate memory rate
        # for a symmetric read/write mix.  Charged bytes = read + write.
        @jax.jit
        def make_big():
            return jnp.full((terms * math.prod(npts),), 0.5, dtype)

        big = make_big()
        jax.block_until_ready(big)

        def step(x):
            return x * jnp.float32(0.9999) + jnp.float32(1e-7)

        wall = time_step_loop(step, big, iters=iters)
        isize = jnp.dtype(dtype).itemsize
        nbytes = 2 * terms * math.prod(npts) * isize   # read + write
        gbps = nbytes / wall / 1e9
        return BenchResult(
            name=f"spmv_banded_{impl}_{len(npts)}d_p{degree}",
            dtype=str(jnp.dtype(dtype)), grid=npts, wall_s=wall,
            gbytes_per_s=gbps, gnnz_per_s=0.0,
            pct_sol=100.0 * gbps / sol_bandwidth())
    elif impl == "xlastream":
        # Measured ceiling: a plain XLA multiply-accumulate stream over the
        # SAME traffic as the banded kernel (band read once, x
        # broadcast-read, y written), chained through the loop carry so
        # LICM cannot hoist the band read.
        @jax.jit
        def make_band():
            k = jax.random.PRNGKey(0)
            flat = jax.random.normal(k, (terms, math.prod(npts)), dtype)
            return flat / (2.0 * math.sqrt(terms))

        band_flat = make_band()
        jax.block_until_ready(band_flat)

        def step(x, bnd):
            return jnp.tanh((bnd * x[None, :]).sum(0))

        x0f = jnp.full((math.prod(npts),), 1e-3, dtype)
        wall = time_step_loop(step, x0f, consts=(band_flat,), iters=iters)
    elif impl == "jnp":
        # operands are generated on device: the 3D cubic band is GBs
        @jax.jit
        def make_operands():
            k1, k2 = jax.random.split(jax.random.PRNGKey(0))
            # offset-major band (win..., grid...) — core/matrix.py layout
            band_t = jax.random.normal(k1, band_shape + npts, dtype)
            band_t = band_t / (2.0 * math.sqrt(terms))
            x0 = jax.random.normal(
                k2, tuple(n + 2 * degree for n in npts), dtype)
            return band_t, x0

        band, x0 = make_operands()
        jax.block_until_ready(band)
        from poms_tpu.ops.spmv import spmv_banded_jnp

        pad_widths = [(degree, degree)] * d

        def step(x_pad, bnd):
            y = spmv_banded_jnp(bnd, x_pad, npts, pads)
            return jnp.pad(y, pad_widths)

        wall = time_step_loop(step, x0, consts=(band,), iters=iters)
    else:
        raise ValueError(impl)
    points = math.prod(npts)
    isize = jnp.dtype(dtype).itemsize
    if impl == "kron":
        nbytes = (2 * points + 2 * sum(npts) * (2 * degree + 1)) * isize
    else:
        # the band once, x read, y written
        nbytes = (terms + 2) * points * isize
    nnz = terms * points
    gbps = nbytes / wall / 1e9
    return BenchResult(
        name=f"spmv_banded_{impl}_{d}d_p{degree}", dtype=str(jnp.dtype(dtype)),
        grid=npts, wall_s=wall, gbytes_per_s=gbps,
        gnnz_per_s=nnz / wall / 1e9, pct_sol=100.0 * gbps / sol_bandwidth())


def bench_vcycle(dim: int, n_el: int, degree: int, num_levels: int,
                 dtype=jnp.float32, iters: int = 5):
    """Seconds per V-cycle (chained on device, overhead-cancelled)."""
    from poms_tpu.core.vector import StencilVector
    from poms_tpu.mg.cycles import CycleConfig, cycle
    from poms_tpu.mg.hierarchy import build_hierarchy
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.models.poisson import poisson_problem

    prob = poisson_problem(dim, n_el, degree=degree, dtype=dtype)
    cfg = CycleConfig(smoother=SmootherConfig("jacobi", 0.8))
    levels = build_hierarchy(prob, num_levels)
    b = prob.b

    def step(x, *consts):
        return cycle(levels, 0, x, b, cfg)

    x0 = StencilVector.zeros(prob.space)
    wall = time_step_loop(step, x0, consts=(), iters=iters)
    return wall, prob
