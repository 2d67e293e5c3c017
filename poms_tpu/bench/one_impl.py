"""Run one SpMV benchmark impl in its own process.

``bench.py`` runs ``python -m poms_tpu.bench.one_impl <impl> <d> <n>
<degree>`` for each implementation in turn, so that one process at a time
holds the card, and parses the single RESULT line.
"""
import json
import sys


def main():
    impl = sys.argv[1]
    d = int(sys.argv[2])
    # <n> is either a cube edge ("128") or an explicit grid ("64x32x128")
    n_s = sys.argv[3]
    degree = int(sys.argv[4])
    iters = int(sys.argv[5]) if len(sys.argv) > 5 else 20
    dtype_s = sys.argv[6] if len(sys.argv) > 6 else "f32"

    import jax
    import jax.numpy as jnp

    from poms_tpu.bench.roofline import bench_spmv, sol_bandwidth
    from poms_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_s]
    npts = (tuple(int(s) for s in n_s.split("x")) if "x" in n_s
            else (int(n_s),) * d)
    r = bench_spmv(npts, degree=degree, dtype=dtype, iters=iters,
                   impl=impl)
    dev = jax.devices()[0]
    print("RESULT " + json.dumps({
        "name": r.name, "wall_s": r.wall_s, "gbytes_per_s": r.gbytes_per_s,
        "gnnz_per_s": r.gnnz_per_s, "pct_sol": r.pct_sol,
        "peak_gbps": sol_bandwidth(dev), "device_kind": dev.device_kind,
        "grid": list(r.grid), "dtype": r.dtype}), flush=True)


if __name__ == "__main__":
    main()
