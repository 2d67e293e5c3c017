"""Overlap trace-capture machinery (VERDICT r2 ask #6).

On the CPU mesh this validates capture → parse → classify → report; true
concurrency numbers require several real cards (bench/overlap_trace.py
runs on whatever devices JAX finds).
"""
from poms_tpu.bench.overlap_trace import (_intersect_len, _merge,
                                          overlap_report, run_overlap_check)


def test_interval_math():
    assert _merge([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert _intersect_len([[0, 10]], [[2, 4], [8, 12]]) == 4.0


def test_overlap_report_classification():
    events = [
        {"name": "collective-permute-start.1", "ts": 0.0, "dur": 10.0},
        {"name": "fusion.42", "ts": 2.0, "dur": 4.0},
        {"name": "copy.3", "ts": 20.0, "dur": 5.0},
    ]
    rep = overlap_report(events)
    assert rep["n_comm_events"] == 1
    assert rep["n_compute_events"] == 2
    assert rep["overlapped_us"] == 4.0
    assert abs(rep["overlap_fraction"] - 0.4) < 1e-12


def test_capture_on_mesh(tmp_path):
    """End-to-end: profile one sharded step and get a parseable report."""
    rep = run_overlap_check(str(tmp_path / "overlap.json"), n_el=16)
    assert rep["n_comm_events"] > 0, rep
    assert rep["n_compute_events"] > 0, rep
    f = rep["overlap_fraction"]
    assert f is None or 0.0 <= f <= 1.0


def test_overlap_ab_control(tmp_path):
    """A/B control (VERDICT r3 ask #5): both arms produce fractions.

    On the CPU mesh the control (overlap=False) fraction is statistically
    indistinguishable from the treatment — XLA:CPU executes collectives
    synchronously, so CPU traces cannot prove (or disprove) overlap on the
    cards.  The test therefore asserts the MACHINERY (both arms parse,
    fractions in range), not an inequality the backend cannot express."""
    from poms_tpu.bench.overlap_trace import run_overlap_ab

    rep = run_overlap_ab(str(tmp_path / "ab.json"), n_el=16)
    for arm in ("overlap_true", "overlap_false"):
        assert rep[arm]["n_comm_events"] > 0, rep[arm]
        f = rep[arm]["overlap_fraction"]
        assert f is None or 0.0 <= f <= 1.0
    assert (tmp_path / "ab.json").exists()
