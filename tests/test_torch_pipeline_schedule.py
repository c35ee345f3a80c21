"""The port's pipeline-schedule arithmetic and trace helpers against the
JAX reference (no ranks).

``distributed.overlap``'s ``F_TICK``, ``B_TICK``,
``schedule_constants``, ``schedule_events``, ``transfer_stats``,
``overlap_fraction`` and ``measured_overlap`` equal the reference's for
every pp <= 4 and n_micro <= 8, lockstep and overlapped;
``trace.record_pipeline_schedule`` round-trips through
``pipeline_schedule_events`` (and the reference's reader), and
``tools/trace_report.py``'s ``pipeline_overlap`` and
``_rank_schedule_verdict`` read the port's sidecar and find it equal to
the static model.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from paddle_tpu.distributed import overlap as jov
from paddle_tpu.profiler import trace as jtrace
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import overlap as tov
from paddle_tpu_torch.profiler import trace as ttrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_REPORT = os.path.join(REPO, "tools", "trace_report.py")
GRID = [(pp, overlap) for pp in range(1, 5) for overlap in (False, True)]


def _trace_report():
    spec = importlib.util.spec_from_file_location("trace_report",
                                                  TRACE_REPORT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def trace_on():
    tflags.set_flags({"FLAGS_tpu_trace": True})
    ttrace.clear()
    yield
    ttrace.clear()
    tflags.set_flags({"FLAGS_tpu_trace": False})


@pytest.mark.parametrize("pp,overlap", GRID)
def test_schedule_arithmetic_matches_jax(pp, overlap):
    for n_micro in range(1, 9):
        assert tov.schedule_constants(pp, n_micro, overlap=overlap) == \
            jov.schedule_constants(pp, n_micro, overlap=overlap)
        for s in range(pp):
            for m in range(n_micro):
                assert tov.F_TICK(s, m, overlap=overlap) == \
                    jov.F_TICK(s, m, overlap=overlap)
                assert tov.B_TICK(s, m, pp, overlap=overlap) == \
                    jov.B_TICK(s, m, pp, overlap=overlap)


@pytest.mark.parametrize("pp,overlap", GRID)
def test_schedule_events_and_scores_match_jax(pp, overlap):
    for n_micro in range(1, 9):
        log = []
        evs = tov.schedule_events(pp, n_micro, overlap=overlap, log=log)
        assert evs is log
        assert evs == jov.schedule_events(pp, n_micro, overlap=overlap)
        assert tov.transfer_stats(evs) == jov.transfer_stats(evs)
        assert tov.overlap_fraction(evs) == jov.overlap_fraction(evs)
        assert tov.measured_overlap(evs) == jov.measured_overlap(evs)
    with pytest.raises(ValueError):
        tov.schedule_events(pp, 0, overlap=overlap)


@pytest.mark.parametrize("overlap", [False, True])
def test_record_pipeline_schedule_round_trips(trace_on, overlap):
    n = ttrace.record_pipeline_schedule(3, 5, overlap=overlap, step=0)
    static = tov.schedule_events(3, 5, overlap=overlap)
    assert n == len(static)
    assert ttrace.pipeline_schedule_events() == static
    assert ttrace.pipeline_schedule_events(step=0) == static
    assert ttrace.pipeline_schedule_events(step=1) == []
    # the reference's reader takes the port's events
    evs = json.loads(json.dumps(ttrace.events()))
    assert jtrace.pipeline_schedule_events(evs) == static
    assert tov.measured_overlap(ttrace.pipeline_schedule_events()) == \
        tov.measured_overlap(static)


def test_record_pipeline_schedule_off_records_nothing():
    ttrace.clear()
    assert ttrace.record_pipeline_schedule(2, 4, overlap=True) is None
    assert ttrace.events() == []


@pytest.mark.parametrize("overlap", [False, True])
def test_trace_report_reads_the_port_sidecar(trace_on, tmp_path, overlap):
    """``pipeline_overlap`` scores the port's recorded schedule as the
    simulator does, ``_rank_schedule_verdict`` finds it equal to the
    static model, and the report's command line reads the sidecar."""
    ttrace.record_pipeline_schedule(2, 4, overlap=overlap, step=0)
    path = ttrace.write_sidecar(ttrace.sidecar_path(str(tmp_path), rank=0))
    _, evs = ttrace.read_sidecar(path)
    tr = _trace_report()
    static = tov.schedule_events(2, 4, overlap=overlap)
    got = tr.pipeline_overlap(evs)
    assert got["schedule_events"] == static
    assert got["overlap_fraction"] == tov.overlap_fraction(static)
    assert {k: got[k] for k in ("total_transfers",
                                "serialized_transfers")} == \
        tov.transfer_stats(static)
    verdict = tr._rank_schedule_verdict(evs)
    assert verdict["matches_static"] is True
    assert (verdict["pp"], verdict["n_micro"], verdict["overlap"]) == \
        (2, 4, overlap)
    proc = subprocess.run([sys.executable, TRACE_REPORT, str(tmp_path)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["pipeline"]["overlap_fraction"] == \
        tov.overlap_fraction(static)
