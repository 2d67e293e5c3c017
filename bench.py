#!/usr/bin/env python
"""Benchmark entry point.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Primary metric (BASELINE.json:2): banded stencil SpMV throughput on the
3D cubic-B-spline operator (config 3's hot kernel), f32, one card.
``vs_baseline``: achieved Gnnz/s ÷ the banded-storage roofline of the card
(published memory bandwidth / 8 B per nonzero; the reference publishes no
numbers, so the roofline is the baseline).

Each implementation and solve runs in its own process, one at a time and
under a timeout, and this parent never imports JAX: a JAX process
reserves most of the card's memory when it first uses it, so only one
process may hold the card at a time.  Human-readable rows go to stderr.
"""
import json
import os
import subprocess
import sys

TIMEOUT_S = int(os.environ.get("POMS_BENCH_TIMEOUT", "1500"))
DIM, N, DEGREE = 3, 128, 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _run_subproc(cmd, tag):
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=TIMEOUT_S,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        log(f"{tag}: TIMEOUT after {TIMEOUT_S}s")
        return None
    for line in proc.stdout.splitlines():
        # take the first RESULT line that parses as JSON
        if line.startswith("RESULT "):
            try:
                return json.loads(line[len("RESULT "):])
            except json.JSONDecodeError:
                continue
    tail = (proc.stderr or "").strip().splitlines()[-3:]
    log(f"{tag}: no result (exit {proc.returncode}); stderr tail: "
        + " | ".join(tail))
    return None


def run_impl(impl, n=None):
    return _run_subproc(
        [sys.executable, "-u", "-m", "poms_tpu.bench.one_impl",
         impl, str(DIM), str(n if n is not None else N), str(DEGREE)],
        f"impl {impl}")


def run_solve(n_el, residual):
    return _run_subproc(
        [sys.executable, "-u", "-m", "poms_tpu.bench.one_solve",
         str(n_el), str(DEGREE), "1e-10", residual],
        f"solve n_el={n_el} residual={residual}")


def run_pcg(n_el, precision):
    return _run_subproc(
        [sys.executable, "-u", "-m", "poms_tpu.bench.one_pcg",
         str(n_el), str(DEGREE), "1e-10", precision],
        f"pcg n_el={n_el} precision={precision}")


def main():
    impls = os.environ.get("POMS_BENCH_IMPLS", "jnp,kron,xlastream").split(",")
    results = {}
    for impl in impls:
        r = run_impl(impl)
        if r is not None:
            results[impl] = r
            log(f"{r['name']} on {r['device_kind']}: "
                f"{r['wall_s']*1e3:.2f} ms  {r['gbytes_per_s']:.1f} GB/s  "
                f"{r['gnnz_per_s']:.2f} Gnnz/s  {r['pct_sol']:.1f}% of the "
                f"{r['peak_gbps']:.0f} GB/s peak")
    # headline metric 2 (BASELINE.json:2): V-cycle wall to 1e-10, 3D —
    # the f64 residual (the default) beside the double-word one, with
    # identical accounting, at every size
    solves = {}
    residuals = os.environ.get("POMS_BENCH_RESIDUALS", "f64,twofloat")
    for n_el in [int(s) for s in
                 os.environ.get("POMS_BENCH_SOLVE", "64,128,256").split(",")
                 if s]:
        solves[n_el] = {}
        for residual in residuals.split(","):
            r = run_solve(n_el, residual)
            if r is not None:
                solves[n_el][r["residual_mode"]] = r
                log(f"{r['name']}: {r['iterations']} cycles x "
                    f"{r['per_iter_s']*1e3:.1f} ms = "
                    f"{r['wall_to_tol_s']:.3f} s"
                    f" (converged={r['converged']}, host-loop "
                    f"{r['host_loop_per_iter_s']*1e3:.1f} ms/iter)")
        if not solves[n_el]:
            del solves[n_el]
    # MG-preconditioned CG on the kron operator, f64 beside double-word
    pcgs = {}
    for n_el in [int(s) for s in
                 os.environ.get("POMS_BENCH_PCG", "64,128,256,512")
                 .split(",") if s]:
        pcgs[n_el] = {}
        for precision in ("f64", "dw"):
            r = run_pcg(n_el, precision)
            if r is not None:
                pcgs[n_el][precision] = r
                log(f"{r['name']}: {r['iterations']} iters x "
                    f"{r['per_iter_s']*1e3:.1f} ms = "
                    f"{r['wall_to_tol_s']:.3f} s"
                    f" (converged={r['converged']})")
        if not pcgs[n_el]:
            del pcgs[n_el]
    # the headline is the banded apply: the kron apply moves O(n) data,
    # not the band, so its Gnnz/s (banded-equivalent nonzeros) is no
    # banded-storage rate
    best = results.get("jnp")
    if best is None:
        print(json.dumps({"metric": "spmv_3d_cubic_f32_gnnz_per_s",
                          "value": 0.0, "unit": "Gnnz/s",
                          "vs_baseline": 0.0}))
        return 1
    _PROBES = ("xlastream", "xlastreamrw")
    # baseline = the card's banded-storage speed-of-light (peak GB/s over
    # 8 B per nonzero); >1 would mean beating what ANY banded
    # implementation could reach on this card
    sol_gnnz = best["peak_gbps"] / 8.0
    doc = {
        "metric": "spmv_3d_cubic_f32_gnnz_per_s",
        "value": round(best["gnnz_per_s"], 2),
        "unit": "Gnnz/s",
        "vs_baseline": round(best["gnnz_per_s"] / sol_gnnz, 4),
        "device_kind": best["device_kind"],
        # the plain-XLA stream probes of this run: the measured ceiling
        "measured_stream_ceiling_gbps": (max(
            (round(results[p]["gbytes_per_s"], 1)
             for p in _PROBES if p in results), default=None)),
        "vcycle3d_to_1e10": {
            str(n): {mode: {"wall_s": round(r["wall_to_tol_s"], 4),
                            "iterations": r["iterations"],
                            "per_iter_s": round(r["per_iter_s"], 5),
                            "host_loop_per_iter_s":
                                round(r["host_loop_per_iter_s"], 5),
                            "converged": r["converged"]}
                     for mode, r in by_mode.items()}
            for n, by_mode in solves.items()},
        "pcg3d_to_1e10": {
            str(n): {precision: {"wall_s": round(r["wall_to_tol_s"], 4),
                                 "iterations": r["iterations"],
                                 "per_iter_s": round(r["per_iter_s"], 5),
                                 "converged": r["converged"]}
                     for precision, r in by_precision.items()}
            for n, by_precision in pcgs.items()},
    }
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
