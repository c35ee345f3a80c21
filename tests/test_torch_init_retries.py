"""Device init with retries (``paddle_tpu_torch.runtime.watchdog
.init_with_retries``) against the reference's
(``tests/test_runtime_health.py``'s ``TestInitWithRetries``).

Both run under the same injected failures, fake sleep and fake clock:
the attempts, the sleeps of the backoff, the result and the incident
records (all fields but the time, rank and pid of the process) are
equal.  A hung attempt is not retried and records ``watchdog_expired``.
The bench's own entry point returns non-zero with the error result when
the window runs out, and never goes on on the CPU.
"""
import json
import threading

import pytest

from paddle_tpu.runtime import watchdog as jwd
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch.runtime import watchdog as twd


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _run(wd, fail_first, window_s=240.0, base_delay=5.0, **kw):
    wd.clear_incidents()
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        if calls["n"] <= fail_first:
            raise RuntimeError(f"claim refused ({calls['n']})")

    clk = _FakeClock()
    sleeps, logs = [], []

    def fake_sleep(s):
        sleeps.append(s)
        clk.advance(s)

    out = wd.init_with_retries(probe, window_s=window_s,
                               base_delay=base_delay, sleep=fake_sleep,
                               clock=clk, log=logs.append, **kw)
    recs = [{k: v for k, v in r.items() if k not in ("time", "rank", "pid")}
            for r in wd.incidents()]
    return out, sleeps, logs, recs


@pytest.mark.parametrize("fail_first,kw", [
    (0, {}), (2, {}), (6, dict(max_delay=20.0)),
    (100, dict(window_s=100.0)), (100, dict(window_s=7.0, factor=3.0))],
    ids=["first_try", "third_try", "capped_backoff", "window_spent",
         "short_window"])
def test_schedule_and_result_equal_reference(fail_first, kw):
    port = _run(twd, fail_first, **kw)
    assert port == _run(jwd, fail_first, **kw)
    (ok, attempts, err), sleeps, _, recs = port
    if fail_first == 2:
        assert ok and attempts == 3 and err is None
        assert sleeps == [5.0, 10.0]
    if fail_first == 100:
        assert not ok and recs[-1]["kind"] == "init_failed"


@pytest.mark.parametrize("wd", [twd, jwd], ids=["port", "reference"])
def test_hung_attempt_is_not_retried(wd):
    wd.clear_incidents()
    release = threading.Event()
    try:
        ok, attempts, err = wd.init_with_retries(release.wait, window_s=0.2)
        assert not ok and attempts == 1 and "hung" in err
        rec = wd.last_incident()
        assert rec["kind"] == "watchdog_expired"
        assert rec["phase"] == "device_init"
        assert rec["detail"] == "init attempt 1 hung"
    finally:
        release.set()


def test_bench_alias_and_probe_without_a_card():
    clk = _FakeClock()
    ok, attempts, err = tbench._init_device_with_retries(
        lambda: None, sleep=clk.advance, clock=clk)
    assert (ok, attempts, err) == (True, 1, None)
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twd.probe_device()


def test_bench_exits_nonzero_when_the_window_runs_out(monkeypatch, capsys,
                                                    tmp_path):
    """A card that refuses every init (its probe patched to fail): the
    bench retries inside a window of 0.3 s, prints the error result with
    the ``init_failed`` incident and returns 1 without running."""
    import torch

    def refuse(device=None):
        raise RuntimeError("claim refused")

    monkeypatch.setenv("PADDLE_TPU_BENCH_DEVICE_TIMEOUT", "0.3")
    monkeypatch.setenv("PADDLE_TPU_BENCH_DEVICE_RETRY_DELAY", "0.05")
    monkeypatch.setenv("PADDLE_TPU_INCIDENT_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(twd, "probe_device", refuse)
    monkeypatch.setattr(tbench, "measure", lambda *a, **k: pytest.fail(
        "the bench ran past a failed device init"))
    twd.clear_incidents()
    assert tbench.main([]) == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["value"] is None and "device init failed" in res["error"]
    assert "claim refused" in res["error"]
    assert res["incident"]["kind"] == "init_failed"
    assert res["incident"]["attempts"] >= 2
