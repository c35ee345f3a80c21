"""The port's serve bench (``python -m paddle_tpu_torch.bench_serve``).

On the CPU it serves ``llama-debug`` (the reference bench's default
shape) with the plain versions and prints one ``BENCH_SERVE`` line with
the reference's field names, for bf16 and int8 KV pages and for the
shared-prefix workload (with and without self-draft speculation), with
its resilience and SLO blocks; its synthetic workloads are the reference's,
arrival for arrival; without a card and without ``--device`` it exits
non-zero with the error in its line.  The line's ``fleet`` block is the
engine's service model calibrated from the run's own step times;
``--trace-out`` writes a sidecar that ``tools/trace_report.py`` reads;
with ``FLAGS_tpu_metrics_port`` set the line carries the bound port and
the exporter serves the run's counters.
"""
import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from paddle_tpu.serving import workloads as jworkloads
from paddle_tpu_torch import bench_serve, flags, serving
from paddle_tpu_torch.profiler import exporter, metrics, trace
from paddle_tpu_torch.serving import autoscale as tautoscale
from paddle_tpu_torch.serving import workloads as tworkloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELDS = ("metric", "value", "unit", "ttft_p50_ms", "ttft_p95_ms",
          "latency_p50_ms", "latency_p95_ms", "requests", "shed_submits",
          "tokens", "steps", "wall_seconds", "prefill_tokens",
          "decode_tokens", "preemptions", "max_running", "chunk",
          "page_size", "kv", "preset", "device", "chips", "resilience",
          "forwards", "forwards_per_step")

SMALL = {"PADDLE_TPU_BENCH_SERVE_REQUESTS": "6",
         "PADDLE_TPU_BENCH_SERVE_NEW": "5"}


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("BENCH_SERVE ")
    return json.loads(out[len("BENCH_SERVE "):])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cpu_run_prints_the_line(kv_dtype, capsys, monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    assert bench_serve.main(["--device", "cpu", "--kv-dtype",
                             kv_dtype]) == 0
    res = _line(capsys)
    assert all(f in res for f in FIELDS), set(FIELDS) - set(res)
    assert res["metric"] == "serve_tokens_per_sec_chip"
    assert res["value"] > 0 and res["device"] == "cpu"
    assert res["preset"] == "llama-debug"
    assert res["requests"] == 6 and res["tokens"] == 6 * 5
    assert res["kv"]["dtype"] == kv_dtype
    assert (res["kv"]["scale_pool_bytes"] > 0) == (kv_dtype == "int8")
    assert res["ttft_p50_ms"] <= res["ttft_p95_ms"]
    assert res["latency_p50_ms"] <= res["latency_p95_ms"]
    assert "reuse" not in res


@pytest.mark.parametrize("spec_k", [0, 3])
def test_shared_prefix_turns_on_the_prefix_cache_only(spec_k, monkeypatch):
    # the reference's shared-prefix run: prefix cache plus self-draft
    # speculation with k = SPEC_K (3 by default; 0 turns it off)
    monkeypatch.setenv("PADDLE_TPU_BENCH_SERVE_REQUESTS", "6")
    monkeypatch.setenv("PADDLE_TPU_BENCH_SERVE_NEW", "4")
    monkeypatch.setenv("PADDLE_TPU_BENCH_SERVE_SPEC_K", str(spec_k))
    run = bench_serve.serve("cpu", kv_dtype="int8", workload="shared-prefix")
    res, eng = run.result, run.engine
    reuse = res["reuse"]
    assert reuse["prefix_cache"] and reuse["spec_k"] == spec_k
    assert reuse["prefix_hit_tokens"] > 0
    assert 0 < reuse["prefix_hit_rate"] <= 1
    assert eng.kv.prefix is not None and eng.kv.audit()["ok"]
    assert all(len(eng.output_of(r)) == 4 for r in run.rids)
    fw = res["forwards"]
    if spec_k:
        assert 0 < reuse["spec_accepted"] <= reuse["spec_proposed"]
        assert reuse["spec_acceptance_rate"] == (
            reuse["spec_accepted"] / reuse["spec_proposed"])
        assert fw["mirror"] == fw["target"] and fw["propose"] > 0
        assert fw["propose"] % spec_k == 0
        # the self-draft runs on the engine's own weights
        assert eng._draft.params is eng.params
        assert reuse["draft_pool_bytes"] == eng._draft.pool_bytes > 0
        assert res["verify_steps"] > 0 and res["decode_steps"] == 0
    else:
        assert reuse["spec_proposed"] == reuse["spec_accepted"] == 0
        assert eng._draft is None and reuse["draft_pool_bytes"] == 0
        assert fw["mirror"] == fw["propose"] == 0
    assert fw["target"] == res["steps"] and fw["probe"] == 0
    assert res["forwards_per_step"] == sum(fw.values()) / res["steps"]


def test_the_line_carries_the_resilience_and_slo_blocks(capsys,
                                                        monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PADDLE_TPU_BENCH_SERVE_TTFT_SLO_MS", "1e9")
    monkeypatch.setenv("PADDLE_TPU_BENCH_SERVE_LAT_SLO_MS", "1e-9")
    assert bench_serve.main(["--device", "cpu"]) == 0
    res = _line(capsys)["resilience"]
    for key in ("shed", "admission_waits", "recoveries", "quarantined",
                "deadline_expired", "callback_errors"):
        assert res[key] == 0, key
    slo = res["slo"]
    assert slo["ttft_slo_ms"] == 1e9 and slo["ttft_ok"] is True
    assert slo["latency_slo_ms"] == 1e-9 and slo["latency_ok"] is False
    assert 0 < slo["ttft_p95_ms"] <= slo["latency_p95_ms"]


@pytest.mark.parametrize("preset", jworkloads.PRESETS)
def test_workloads_match_the_reference(preset):
    kw = dict(seed=3, horizon_s=30.0, prompt_len=10, max_new_tokens=4,
              vocab=50, n_groups=3)
    ref = jworkloads.generate(preset, 17, **kw)
    got = tworkloads.generate(preset, 17, **kw)
    assert [(a.t_s, a.prompt, a.max_new_tokens, a.group) for a in got] \
        == [(a.t_s, a.prompt, a.max_new_tokens, a.group) for a in ref]
    assert tworkloads.step_schedule(got, 34).keys() \
        == jworkloads.step_schedule(ref, 34).keys()
    assert tworkloads.mean_rate(got) == jworkloads.mean_rate(ref)
    assert tworkloads.peak_rate(got) == jworkloads.peak_rate(ref)


def test_unknown_workload_and_kv_dtype_fail(capsys):
    assert bench_serve.main(["--device", "cpu", "--workload", "nope"]) != 0
    assert "unknown workload preset" in _line(capsys)["error"]
    with pytest.raises(ValueError, match="unknown kv dtype"):
        bench_serve.serve("cpu", kv_dtype="fp8")


def test_knobs_read_the_reference_names():
    k = bench_serve.knobs({"PADDLE_TPU_BENCH_SERVE_PROMPT": "1024",
                           "PADDLE_TPU_BENCH_SERVE_CHUNK": "64",
                           "PADDLE_TPU_BENCH_SERVE_PAGES": "300"})
    assert (k["PROMPT"], k["CHUNK"], k["PAGES"]) == (1024, 64, 300)
    assert (k["REQUESTS"], k["NEW"], k["MAX_QUEUE"]) == (16, 16, 64)


def test_without_a_card_or_a_device_it_exits_non_zero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_serve.main([]) != 0
    res = _line(capsys)
    assert "no CUDA device" in res["error"] and res["value"] is None


def test_the_line_carries_the_fleet_block(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    run = bench_serve.serve("cpu")
    res, eng = run.result, run.engine
    fleet = res["fleet"]
    sm = eng.service_model()
    assert fleet["calibrated"] is True and sm.calibrated
    # calibrated from this run's steps of both buckets, not placeholders
    assert fleet["decode_steps_measured"] == res["decode_steps"] > 0
    assert fleet["prefill_steps_measured"] == res["prefill_steps"] > 0
    assert fleet["decode_step_ms"] == 1e3 * sm.decode_step_s
    assert fleet["prefill_chunk_ms"] == 1e3 * sm.prefill_chunk_s
    assert fleet["concurrency"] == sm.concurrency
    mean_prompt = sum(len(eng.request(r).prompt) for r in run.rids) // 6
    assert fleet["capacity_rps_per_chip"] == sm.capacity_rps(mean_prompt, 5)
    assert fleet["offered_rps"] == 6 / res["wall_seconds"]
    assert fleet["min_chips_for_offered"] == tautoscale.replicas_for(
        sm, fleet["offered_rps"], prompt_len=mean_prompt, new_tokens=5)
    assert "trace_sidecar" not in res and "metrics_port" not in res


def test_trace_out_writes_a_sidecar_trace_report_reads(tmp_path, capsys,
                                                       monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "trace"
    assert bench_serve.main(["--device", "cpu", "--trace-out",
                             str(out)]) == 0
    res = _line(capsys)
    path = res["trace_sidecar"]
    assert path == str(out / "trace_rank0.jsonl")
    assert not flags.flag("FLAGS_tpu_trace"), "the flag outlived the run"
    header, evs = trace.read_sidecar(path)
    assert header["bench"] == "serve" and header["requests"] == 6
    rids = {e["rid"] for e in evs if e.get("phase") == "queued"}
    assert len(rids) == 6      # the measured run's requests only
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         str(out)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["requests"]["count"] == report["requests"]["terminal"] == 6
    trace.clear()


def test_metrics_port_serves_the_run(capsys, monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    flags.set_flags({"FLAGS_tpu_metrics_port": -1,
                     "FLAGS_tpu_metrics": True})
    exporter.shutdown()
    metrics.reset()
    serving.reset_stats()
    try:
        assert bench_serve.main(["--device", "cpu"]) == 0
        res = _line(capsys)
        port = res["metrics_port"]
        assert port == exporter.active().port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        line = next(ln for ln in body.splitlines()
                    if ln.startswith("serve_decode_tokens_total "))
        assert float(line.split()[1]) == \
            serving.serving_stats()["decode_tokens"]
    finally:
        flags.set_flags({"FLAGS_tpu_metrics_port": 0,
                         "FLAGS_tpu_metrics": False})
        exporter.shutdown()
        metrics.reset()
