"""Comm/compute-overlap verification from profiler traces (SURVEY §7.1.7).

VERDICT r2 ask #6: "prove overlap, don't just allow it".  The overlap
formulation (parallel/halo.py::dist_spmv(overlap=True)) emits the halo
ppermute and the interior SpMV as independent ops; whether XLA actually
schedules them concurrently is only visible in a trace.  This module

1. captures a `jax.profiler.trace` (perfetto/Chrome-JSON form) around a
   sharded step,
2. parses the event stream into (name, start, duration) intervals,
3. classifies events into COMM (collective-permute / all-gather /
   all-reduce and their async start/done pairs) and COMPUTE (fusions,
   loops, dots, custom-calls), and
4. reports the fraction of total comm wall-time that lies under an open
   compute interval — the overlap fraction.

Usage:  python -m poms_tpu.bench.overlap_trace [out.json]
(runs on the devices JAX finds: a virtual CPU mesh validates the
MACHINERY; scheduling truth needs several real cards.)
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
from typing import Dict, List, Tuple

__all__ = ["capture_trace", "parse_perfetto", "overlap_report",
           "run_overlap_check"]

# XLA's collective op names, and "nccl" for the NCCL kernels that carry
# them on a GPU (e.g. ncclDevKernel_SendRecv for a collective-permute)
_COMM_KEYS = ("collective-permute", "all-gather", "all-reduce",
              "reduce-scatter", "collective", "nccl")
_SKIP_KEYS = ("thread", "process", "Steps", "profiler", "Flow")


def capture_trace(fn, args, log_dir: str) -> str:
    """Run ``fn(*args)`` under the profiler; return the perfetto JSON path."""
    import jax

    with jax.profiler.trace(log_dir, create_perfetto_trace=True):
        out = fn(*args)
        jax.block_until_ready(out)
    hits = glob.glob(os.path.join(log_dir, "**", "*perfetto*"),
                     recursive=True)
    if not hits:
        raise FileNotFoundError(f"no perfetto trace under {log_dir}")
    return hits[0]


def parse_perfetto(path: str) -> List[Dict]:
    """Flatten a perfetto/Chrome JSON trace to complete ('X') events."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if any(k in name for k in _SKIP_KEYS):
            continue
        out.append({"name": name, "ts": float(e.get("ts", 0.0)),
                    "dur": float(e.get("dur", 0.0)),
                    "tid": e.get("tid"), "pid": e.get("pid")})
    return out


def _merge(intervals: List[Tuple[float, float]]):
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for s, t in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _intersect_len(a, b) -> float:
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_report(events: List[Dict]) -> Dict:
    """Overlap fraction = |comm ∩ compute| / |comm| (merged wall intervals)."""
    comm, compute = [], []
    for e in events:
        lo = e["name"].lower()
        iv = (e["ts"], e["ts"] + e["dur"])
        if e["dur"] <= 0:
            continue
        if any(k in lo for k in _COMM_KEYS):
            comm.append(iv)
        elif any(k in lo for k in ("fusion", "dot", "convolution", "copy",
                                   "while", "custom-call", "loop", "slice",
                                   "concatenate", "dynamic")):
            compute.append(iv)
    comm_m, comp_m = _merge(comm), _merge(compute)
    comm_total = sum(t - s for s, t in comm_m)
    inter = _intersect_len(comm_m, comp_m)
    return {
        "n_comm_events": len(comm),
        "n_compute_events": len(compute),
        "comm_wall_us": comm_total,
        "overlapped_us": inter,
        "overlap_fraction": (inter / comm_total) if comm_total > 0 else None,
    }


def run_overlap_check(out_json: str | None = None, n_el: int = 32,
                      overlap: bool = True) -> Dict:
    """Capture + analyze one sharded 2D step on the available mesh."""
    import jax
    import jax.numpy as jnp

    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.parallel.dist import DistributedMG

    ndev = len(jax.devices())
    mesh_shape = (2, ndev // 2) if ndev >= 4 else (min(2, ndev), 1)
    prob = poisson_problem(2, n_el, degree=2, dtype=jnp.float64)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig(kind="jacobi", omega=0.8))
    mg = DistributedMG(prob, num_levels=2, mesh_shape=mesh_shape, cfg=cfg,
                       overlap=overlap)
    b_glob = mg._pad_global(prob.b.interior)
    x_glob = jnp.zeros_like(b_glob)
    x_glob, _ = mg.step(x_glob, b_glob)          # compile + warm OUTSIDE trace
    jax.block_until_ready(x_glob)
    with tempfile.TemporaryDirectory() as td:
        path = capture_trace(lambda x: mg.step(x, b_glob)[0], (x_glob,), td)
        events = parse_perfetto(path)
        rep = overlap_report(events)
    rep["platform"] = jax.devices()[0].platform
    rep["n_devices"] = ndev
    rep["mesh_shape"] = list(mesh_shape)
    rep["overlap_formulation"] = overlap
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


def run_overlap_ab(out_json: str | None = None, n_el: int = 32) -> Dict:
    """A/B control experiment (VERDICT r3 ask #5): capture the SAME sharded
    step with overlap=True and overlap=False and report both fractions —
    round 3 recorded only the treatment arm, which proves nothing about
    whether the overlap formulation buys anything."""
    rep = {"overlap_true": run_overlap_check(None, n_el, overlap=True),
           "overlap_false": run_overlap_check(None, n_el, overlap=False)}
    ft = rep["overlap_true"]["overlap_fraction"]
    ff = rep["overlap_false"]["overlap_fraction"]
    rep["fraction_gain"] = (ft - ff) if (ft is not None and ff is not None) \
        else None
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_enable_x64", True)

    out = sys.argv[1] if len(sys.argv) > 1 else None
    if "--ab" in sys.argv:
        rep = run_overlap_ab(None if out == "--ab" else out)
    else:
        rep = run_overlap_check(out)
    print(json.dumps(rep, indent=1))
