"""The port's Profiler and its sections (``paddle_tpu_torch.profiler``)
against the reference's ``paddle_tpu.profiler``.

- ``make_scheduler``: the states of steps 0-20 equal the reference's for
  several schedules, and the same arguments are refused.
- ``RecordEvent`` / ``_record_span``: calls, totals and maxima by name
  while a Profiler is live; a no-op context otherwise.
- ``export()``: the same Chrome trace structure as the reference's (the
  metadata events naming each pid/tid, then the "X" host events, the
  display unit, ``metadata.steps``), the producer renamed.
- ``summary_table``: the sections the port has, in the reference's order
  (Compilation, Memory, Numerics, Checkpoints, Health, Serving, Fleet).
- ``benchmark.report``: keys and values equal the reference's on the
  same injected clock (the reference's read through a patched
  ``time.perf_counter``).
- ``xmem``: ``record_kernel_estimate`` / ``record_reservation`` /
  ``summary_lines`` against the reference's (the port's kernel estimate
  is shared memory where the reference's is VMEM: the same numbers and
  rows under the other key), ``capture`` of a call on the CPU (bytes and
  FLOPs), ``device.memory_stats``.
- ``compile_tracker``: builds, seconds and cache hits counted through
  ``ops._build`` with nvcc replaced by a script that writes an empty
  library and a ptxas report.
"""
import json
import os
import stat

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as jprof
from paddle_tpu.core import flags as jflags
from paddle_tpu.profiler import xmem as jxmem
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.profiler import compile_tracker, xmem


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2),
    dict(closed=2, ready=0, record=3, repeat=2),
    dict(closed=0, ready=2, record=1, skip_first=3),
    dict(closed=5, ready=0, record=2, repeat=1)])
def test_scheduler_states_equal_reference(kw):
    mine, ref = tprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [mine(s).name for s in range(21)] == [ref(s).name
                                                 for s in range(21)]


@pytest.mark.parametrize("kw", [dict(closed=-1, ready=0, record=1),
                                dict(closed=0, ready=0, record=0),
                                dict(closed=0, ready=0, record=1,
                                     repeat=-1)])
def test_scheduler_refusals_equal_reference(kw):
    with pytest.raises(ValueError) as mine:
        tprof.make_scheduler(**kw)
    with pytest.raises(ValueError) as ref:
        jprof.make_scheduler(**kw)
    assert str(mine.value) == str(ref.value)


def test_record_span_stats():
    assert isinstance(tprof._record_span("x"),
                      type(__import__("contextlib").nullcontext()))
    with tprof.Profiler(timer_only=True) as p:
        for _ in range(3):
            with tprof._record_span("a"):
                pass
        with tprof.RecordEvent("b"):
            pass
    assert p._span_stats["a"][0] == 3 and p._span_stats["b"][0] == 1
    calls, total, mx = p._span_stats["a"]
    assert 0 <= mx <= total
    assert not tprof._ACTIVE_PROFILERS


def _export(mod, path):
    p = mod.Profiler(timer_only=True)
    p.start()
    with mod.RecordEvent("outer"):
        with mod.RecordEvent("inner"):
            pass
    p.step()
    p.stop()
    p.export(path)
    with open(path) as f:
        return json.load(f)


def test_export_structure_equals_reference(tmp_path):
    mine = _export(tprof, str(tmp_path / "port.json"))
    ref = _export(jprof, str(tmp_path / "ref.json"))
    assert sorted(mine) == sorted(ref)
    assert mine["displayTimeUnit"] == ref["displayTimeUnit"] == "ms"
    assert mine["metadata"] == {"producer": "paddle_tpu_torch.profiler",
                                "steps": 1}
    assert ref["metadata"]["producer"] == "paddle_tpu.profiler"

    def shape(evs):
        return [(e["ph"], e["name"], sorted(e)) if e["ph"] == "M" else
                (e["ph"], e["name"], e["cat"], sorted(e)) for e in evs]
    assert shape(mine["traceEvents"]) == shape(ref["traceEvents"])
    meta = [e for e in mine["traceEvents"] if e["ph"] == "M"]
    assert meta[0]["args"]["name"] == f"host {os.getpid()}"


def test_torch_trace_opens_on_record_edges():
    """``scheduler=(1, 3)``: steps 1 and 2 record; the torch profiler is
    open exactly then."""
    p = tprof.Profiler(scheduler=(1, 3))
    p.start()
    open_at = []
    for step in range(5):
        with tprof._record_span("step"):
            torch.ones(4) * 2
        open_at.append(p._torch_prof is not None)
        p.step()
    p.stop()
    assert open_at == [False, True, True, False, False]
    assert hasattr(p, "torch_profile")
    names = [e["name"] for e in p._trace_events]
    assert names == ["step", "step"]


def test_summary_table_sections():
    with tprof.Profiler(timer_only=True) as p:
        with tprof._record_span("work"):
            pass
        p.step()
    table = p.summary_table()
    heads = [ln for ln in table.splitlines()
             if ln and not ln.startswith((" ", "-", "Name", "work",
                                          "avg step"))]
    assert [h.split()[0] for h in heads] == [
        "Compilation", "Memory", "Numerics", "Checkpoints", "Health",
        "Serving", "Fleet"]
    assert "jaxpr traces: no counterpart" in table


def test_benchmark_report_equals_reference(monkeypatch):
    ticks = iter([0.0, 0.5, 1.25, 2.0, 4.0])
    clock_t = iter([0.0, 0.5, 1.25, 2.0, 4.0])
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(ticks))
    ref = jprof.benchmark()
    mine = tprof.benchmark(clock=lambda: next(clock_t))
    for b in (ref, mine):
        b.begin()
        for n in (8, 8, 4, None):
            b.step(n)
        b.end()
    assert mine.report() == ref.report()
    assert mine.report()["steps"] == 4 and mine.report()["ips"] == 21 / 4.0


@pytest.fixture
def xmem_on():
    tflags.set_flags({"FLAGS_tpu_xmem": True})
    jflags.set_flags({"FLAGS_tpu_xmem": True})
    xmem.reset()
    jxmem.reset()
    yield
    tflags.set_flags({"FLAGS_tpu_xmem": False})
    jflags.set_flags({"FLAGS_tpu_xmem": False})
    xmem.reset()
    jxmem.reset()


def test_xmem_estimates_and_reservations_equal_reference(xmem_on):
    for mod in (xmem, jxmem):
        mod.record_kernel_estimate("flash_fwd_kernel", 99 * 1024,
                                   where="flash_attention", registers=168)
        mod.record_kernel_estimate("gemm_tma_kernel", 200 * 1024,
                                   where="fused_blocks", registers=90)
        mod.record_kernel_estimate("flash_fwd_kernel", 98 * 1024,
                                   where="flash_attention", registers=160)
        mod.record_reservation("serving.kv_pages", 3 << 30, pages=100)
        mod.record_reservation("draft", 1 << 20)
        mod.record_reservation("draft", 0)
    assert xmem.reservations() == jxmem.reservations()
    mine = xmem.kernel_estimates()
    ref = jxmem.kernel_estimates()
    assert [{("vmem_bytes" if k == "smem_bytes" else k): v
             for k, v in e.items()} for e in mine] == ref
    lines, rlines = xmem.summary_lines(), jxmem.summary_lines()
    assert lines[0] == rlines[0] == "Memory"
    assert [ln for ln in lines if "reserved" in ln] == \
        [ln for ln in rlines if "reserved" in ln]
    # the kernel rows: name and bytes as the reference prints them
    rows = [ln.split()[:3] for ln in lines if "_kernel" in ln]
    rrows = [ln.split()[:3] for ln in rlines if "_kernel" in ln]
    assert rows == rrows and len(rows) == 2
    assert "168" not in " ".join(lines) and "160 registers" in lines[-2]


def test_xmem_off_records_nothing():
    xmem.record_reservation("x", 10)
    xmem.record_kernel_estimate("k", 10)
    out, prof = xmem.capture("t", "mm", torch.mm, torch.ones(2, 2),
                             torch.ones(2, 2))
    assert prof is None and torch.equal(out, 2 * torch.ones(2, 2))
    assert xmem.reservations() == [] and xmem.kernel_estimates() == []


def test_xmem_metrics_keep_records_but_capture_nothing():
    """FLAGS_tpu_metrics alone keeps the free records (they feed its
    gauges) but profiles no call: capture slows the call and restarts
    the card's peak counter, so it waits for FLAGS_tpu_xmem itself."""
    tflags.set_flags({"FLAGS_tpu_metrics": True})
    try:
        xmem.record_reservation("serving.kv_pages", 1 << 20)
        out, prof = xmem.capture("t", "mm", torch.mm, torch.ones(2, 2),
                                 torch.ones(2, 2))
        assert xmem.enabled() and not xmem.capturing()
        assert prof is None and torch.equal(out, 2 * torch.ones(2, 2))
        assert [r["name"] for r in xmem.reservations()] == [
            "serving.kv_pages"]
        assert xmem.profiles() == []
    finally:
        tflags.set_flags({"FLAGS_tpu_metrics": False})
        tprof.metrics.reset()
        xmem.reset()


def test_xmem_capture_on_the_cpu(xmem_on):
    a, b = torch.ones(4, 6), torch.ones(6, 5)
    out, prof = xmem.capture("test", "mm", torch.mm, a, b, sig=(4, 6, 5))
    assert torch.equal(out, torch.full((4, 5), 6.0))
    assert prof["flops"] == 2 * 4 * 6 * 5
    assert prof["argument_bytes"] == (24 + 30) * 4
    assert prof["output_bytes"] == 20 * 4 and prof["temp_bytes"] == 0
    assert prof["peak_bytes"] == (24 + 30 + 20) * 4
    assert prof["prior_peak_bytes"] == 0     # no card: no peak window
    # an output that aliases an argument is no new bytes
    _, p2 = xmem.capture("test", "inplace", lambda t: t.mul_(2), a)
    assert p2["alias_bytes"] == 24 * 4 and p2["output_bytes"] == 0
    assert xmem.stats()["executables"] == 2
    assert xmem.max_static_peak() == prof["peak_bytes"]
    st = tdevice.memory_stats("cpu")
    assert st["xmem_static_peak_bytes"] == prof["peak_bytes"]
    assert st["peak_bytes_in_use"] == prof["peak_bytes"]
    assert any(ln.strip().startswith("test:mm")
               for ln in xmem.summary_lines())


def test_compile_tracker_counts_builds(tmp_path, monkeypatch, xmem_on):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = \"-o\" ]; then out=\"$2\"; "
        "fi; shift; done\n"
        "echo \"ptxas info    : Compiling entry function '_Z3fooPv' for "
        "'sm_90a'\"\n"
        "echo \"ptxas info    : Used 32 registers, 2048 bytes smem, 400 "
        "bytes cmem[0]\"\n"
        ": > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    compile_tracker.reset()
    report = _build.build_all(ptxas_verbose=True)
    st = compile_tracker.stats()
    n = len(_build.SOURCES)
    assert st["compile_count"] == n and st["persistent_cache_hits"] == 0
    assert st["compile_seconds"] > 0
    assert sorted(st["sources"]) == sorted(_build.SOURCES)
    assert all(r["seconds"] > 0 for r in report.values())
    ks = xmem.kernel_estimates()     # one a source (keyed by "where")
    assert sorted(k["where"] for k in ks) == sorted(_build.SOURCES)
    assert {(k["kernel"], k["smem_bytes"], k["registers"])
            for k in ks} == {("_Z3fooPv", 2048, 32)}
    _build.build_all()
    st = compile_tracker.stats()
    assert st["compile_count"] == n and st["persistent_cache_hits"] == n
    section = "\n".join(tprof.Profiler()._compilation_section())
    assert f"kernel builds (nvcc): {n}" in section
    assert f"libraries already built: {n}" in section
    compile_tracker.reset()
    assert np.isclose(compile_tracker.compile_seconds(), 0.0)
