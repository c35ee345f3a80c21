"""End-to-end tests of the port's multi-process gang runtime (the
counterpart of ``tests/test_gang_runtime.py``).

Every pod is real: worker processes started through ``python -m
paddle_tpu_torch.distributed.launch``, gloo collectives across them,
faults from the chaos harness.  The oracle of the kill and hang tests is
``tests/torch_gang_worker.py``: its arithmetic is exact (dyadic
rationals inside the float64 mantissa), so its loss trajectory is
bit-identical at ANY world size, and is held bit for bit to the JAX
package's own worker (``tests/gang_e2e_worker.py``).  A chaos-interrupted
world-4 pod that final-saves and relaunches at world 2 must resume that
exact trajectory.  Every subprocess carries its own timeout.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from paddle_tpu_torch import bench as tbench

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "torch_gang_worker.py")
_JAX_WORKER = os.path.join(_REPO, "tests", "gang_e2e_worker.py")
_TRACE_REPORT = os.path.join(_REPO, "tools", "trace_report.py")
_POD_TIMEOUT = 180


def _gang_env(**extra):
    """A clean launcher environment: no inherited chaos, gang knobs or
    launcher rank contract; the repository on the path; one CPU device
    for a JAX worker."""
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("PTQ_CHAOS", "PTQ_GANG_", "PADDLE_")):
            env.pop(k)
    env["PYTHONPATH"] = _REPO
    env["JAX_PLATFORMS"] = "cpu"
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+\s*",
                   " ", env.get("XLA_FLAGS", "")).strip()
    if flags:
        env["XLA_FLAGS"] = flags
    else:
        env.pop("XLA_FLAGS", None)
    env.update({k: v for k, v in extra.items() if v is not None})
    return env


def _run(cmd, env, timeout=_POD_TIMEOUT):
    return subprocess.run(cmd, env=env, cwd=_REPO, capture_output=True,
                          text=True, timeout=timeout)


def _parse_marked(text, marker):
    return [json.loads(ln[len(marker) + 1:]) for ln in text.splitlines()
            if ln.startswith(marker + " ")]


def _pod_steps(log_dir):
    recs = []
    for fn in sorted(os.listdir(log_dir)):
        if fn.startswith("workerlog."):
            with open(os.path.join(log_dir, fn)) as f:
                recs.extend(_parse_marked(f.read(), "E2E_STEP"))
    return recs


def _rank_incident_kinds(log_dir):
    out = {}
    for fn in os.listdir(log_dir):
        m = re.match(r"incidents_rank(\d+)\.jsonl$", fn)
        if not m:
            continue
        with open(os.path.join(log_dir, fn)) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        out[int(m.group(1))] = {r["kind"] for r in recs
                                if "kind" in r and "schema" not in r}
    return out


@pytest.fixture(scope="module")
def reference_trajectory(tmp_path_factory):
    """The port's worker uninterrupted in one process: step -> {"loss",
    "ids"}; held bit for bit to the JAX package's worker."""
    d = tmp_path_factory.mktemp("gang_ref")
    runs = {}
    for name, worker in (("port", _WORKER), ("jax", _JAX_WORKER)):
        proc = _run([sys.executable, worker, "--steps", "8",
                     "--ckpt-root", str(d / name)], _gang_env(),
                    timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        steps = _parse_marked(proc.stdout, "E2E_STEP")
        assert [r["step"] for r in steps] == list(range(1, 9))
        runs[name] = {r["step"]: r for r in steps}
    for s in range(1, 9):
        assert runs["port"][s]["loss"] == runs["jax"][s]["loss"], s
        assert runs["port"][s]["ids"] == runs["jax"][s]["ids"]
    return runs["port"]


def _chaos_pod(tmp_path, chaos, extra_env=None):
    log_dir = str(tmp_path / "log")
    ckpt = str(tmp_path / "ckpt")
    env = _gang_env(PTQ_CHAOS=chaos, PTQ_GANG_HEARTBEAT_INTERVAL="0.2",
                    PTQ_GANG_HEARTBEAT_TIMEOUT="2.0", **(extra_env or {}))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--elastic", "--nproc_per_node", "4",
           "--min_nproc", "1", "--max_nproc", "4",
           "--max_restarts", "1", "--teardown_grace", "10",
           "--log_dir", log_dir,
           _WORKER, "--steps", "8", "--ckpt-root", ckpt]
    return _run(cmd, env), log_dir, ckpt


def _assert_recovered_trajectory(log_dir, ckpt, reference):
    """Generation 0 ran world 4 up to step 3, a step-3 checkpoint was
    committed, generation 1 resumed at world 2 from step 4, and every
    recorded step is bit-identical (loss and sample ids) to the
    reference."""
    recs = _pod_steps(log_dir)
    gen0 = [r for r in recs if r["restart"] == 0]
    gen1 = [r for r in recs if r["restart"] == 1]
    assert gen0 and gen1
    assert {r["world"] for r in gen0} == {4}
    assert {r["world"] for r in gen1} == {2}, \
        "relaunch did not honor the chaos resize request"
    assert {r["step"] for r in gen0} == {1, 2, 3}
    assert {r["step"] for r in gen1} == {4, 5, 6, 7, 8}, \
        "generation 1 did not resume from the step-3 checkpoint"
    assert os.path.isdir(os.path.join(ckpt, "step_00000003"))
    for r in recs:
        ref = reference[r["step"]]
        assert r["loss"] == ref["loss"], (r, ref["loss"])
        assert r["ids"] == ref["ids"]


def test_peer_kill_mid_collective_recovers_bit_identical(
        tmp_path, reference_trajectory):
    proc, log_dir, ckpt = _chaos_pod(
        tmp_path,
        "kill@collective.all_reduce:step=3,rank=1,restart=0,resize=2")
    assert proc.returncode == 0, proc.stderr[-2000:]
    _assert_recovered_trajectory(log_dir, ckpt, reference_trajectory)
    kinds = _rank_incident_kinds(log_dir)
    survivors = [r for r in (0, 2, 3) if r in kinds]
    assert survivors, f"no survivor incident sidecars in {log_dir}"
    for r in survivors:
        assert kinds[r] & {"health_exit", "gang_abort", "rank_dead",
                           "collective_timeout"}, (r, kinds[r])
    pod_path = os.path.join(log_dir, "pod_incidents.jsonl")
    if os.path.exists(pod_path):
        with open(pod_path) as f:
            recs = [json.loads(ln) for ln in f.read().splitlines()[1:]]
        teardowns = [r for r in recs if r.get("kind") == "pod_teardown"
                     and r.get("restart") == 0]
        if teardowns:
            classes = {w["rank"]: w["class"]
                       for w in teardowns[-1]["workers"]}
            assert classes.get(1) == "failed", classes


def test_peer_hang_mid_collective_recovers_bit_identical(
        tmp_path, reference_trajectory):
    proc, log_dir, ckpt = _chaos_pod(
        tmp_path,
        "hang@collective.all_reduce:step=3,rank=1,restart=0,resize=2",
        extra_env={"PTQ_GANG_COLLECTIVE_DEADLINE": "2.0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    _assert_recovered_trajectory(log_dir, ckpt, reference_trajectory)
    kinds = _rank_incident_kinds(log_dir)
    assert 1 in kinds, f"no incident sidecar for the hung rank: {kinds}"
    assert "health_exit" in kinds[1], kinds[1]
    # every gang collective is eager and beaconed: the hung rank's own
    # monitor or a peer blocked in the next step's all-reduce fires the
    # deadline first, and the rest follow the gang fail flag
    assert any("collective_timeout" in k for k in kinds.values()), kinds
    for r in (0, 2, 3):
        if r in kinds:
            assert kinds[r] & {"health_exit", "gang_abort"}, (r, kinds[r])


def test_clean_two_process_preset_passes_gang_verdict(tmp_path,
                                                      monkeypatch):
    """``bench --multichip --gang 2``'s measuring function on the CPU:
    the preset's pp=2 1F1B across 2 processes, equal losses, the
    recorded schedules the static one, and the offline verdict."""
    trace_dir = str(tmp_path / "trace")
    for k in list(os.environ):
        if k.startswith(("PTQ_CHAOS", "PTQ_GANG_", "PADDLE_")):
            monkeypatch.delenv(k)
    res = tbench.multichip_gang(2, trace_out=trace_dir, device="cpu",
                                log_dir=str(tmp_path / "log"),
                                timeout=_POD_TIMEOUT)
    det = res["detail"]
    assert det["real_processes"] == 2 and det["world_size"] == 2
    assert det["plan"]["dims"]["pp"] == 2 and det["steps"] == 2
    assert det["matches_static"] == [True, True]
    verdict = _run([sys.executable, _TRACE_REPORT, "--gang", trace_dir],
                   _gang_env(), timeout=60)
    assert verdict.returncode == 0, verdict.stdout[-2000:]
    report = json.loads(verdict.stdout)
    assert report["verdict"] == "pass" and report["ranks_found"] == [0, 1]
    os.remove(os.path.join(trace_dir, "trace_rank1.jsonl"))
    verdict = _run([sys.executable, _TRACE_REPORT, "--gang", trace_dir],
                   _gang_env(), timeout=60)
    assert verdict.returncode == 1
    assert json.loads(verdict.stdout)["missing_ranks"] == [1]


def test_single_process_init_gang_lifecycle(tmp_path):
    """World 1: the same init/step/finalize code path on a self-owned
    store; the sidecar is written and verdict-clean; a latched SIGTERM
    saves at the next boundary and exits 101."""
    trace_dir = str(tmp_path / "trace")
    ckpt = str(tmp_path / "ckpt")
    script = f"""
import os, signal, torch
from paddle_tpu_torch.flags import set_flags
set_flags({{"FLAGS_tpu_trace": True}})
from paddle_tpu_torch.distributed import gang
from paddle_tpu_torch.runtime import health
ctx = gang.init_gang(gang.GangConfig.from_env(
    trace_dir={trace_dir!r}, ckpt_root={ckpt!r}, heartbeat_interval=0.1),
    device="cpu")
assert ctx.rank == 0 and ctx.world_size == 1, (ctx.rank, ctx.world_size)
assert health.get() is ctx.monitor
with ctx.running():
    for step in (1, 2):
        ctx.step_boundary(step, {{"w": torch.full((2,), float(step))}}, {{}})
ctx.finalize()
print("LIFECYCLE_OK", flush=True)
ctx2 = gang.init_gang(gang.GangConfig.from_env(ckpt_root={ckpt!r}),
                      device="cpu")
with ctx2.running():
    ctx2.step_boundary(5, {{"w": torch.ones(2)}}, {{}})
    os.kill(os.getpid(), signal.SIGTERM)
    ctx2.step_boundary(6, {{"w": torch.zeros(2)}}, {{}})
print("NOT REACHED", flush=True)
"""
    proc = _run([sys.executable, "-c", script], _gang_env(), timeout=120)
    assert proc.returncode == 101, proc.stderr[-2000:]
    assert "LIFECYCLE_OK" in proc.stdout and "NOT REACHED" not in proc.stdout
    assert sorted(os.listdir(ckpt)) == ["step_00000006"]
    verdict = _run([sys.executable, _TRACE_REPORT, "--gang", trace_dir],
                   _gang_env(), timeout=60)
    assert verdict.returncode == 0, verdict.stdout[-2000:]
    report = json.loads(verdict.stdout)
    assert report["world_size"] == 1
    assert report["per_rank"][0]["terminal_barrier"] is True
