"""The port's cross-rank health monitor, incident sidecars, chaos grammar
and pod launcher against the JAX package's.

``HealthMonitor`` runs scripted beside the reference's on the same
heartbeat sequences, over a dict store, with an injected clock and exit
function: both must raise the same incident kinds, find the same dead
and straggler sets, set the same gang fail flag and exit 101.  The
launcher's ``classify_exit`` must equal the reference's; a pod relaunches
on 101 without spending its restart budget, gives up after
``max_restarts`` and kills a rank whose heartbeat goes stale.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.runtime import health as jhealth
from paddle_tpu.runtime import watchdog as jwatchdog
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.distributed.fleet import elastic
from paddle_tpu_torch.distributed.mesh import ONE_RANK
from paddle_tpu_torch.runtime import health as thealth
from paddle_tpu_torch.runtime import watchdog as twatchdog
from paddle_tpu_torch.testing import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = ((jhealth, jwatchdog), (thealth, twatchdog))


@pytest.fixture(autouse=True)
def _clean():
    for _, wd in PAIRS:
        wd.clear_incidents()
    yield
    for h, wd in PAIRS:
        h.uninstall()
        wd.clear_incidents()
    tchaos.uninstall()
    jchaos.uninstall()
    tchaos.set_kill_mode("raise")


class DictStore:
    def __init__(self):
        self.d = {}

    def get(self, k):
        return self.d.get(k)

    def set(self, k, v):
        self.d[k] = v


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _peer(store, prefix, rank, n, step, coll=None):
    store.set(f"{prefix}/hb/{rank}", pickle.dumps(
        {"n": n, "step": step, "phase": None, "t": time.time(),
         "pid": 1000 + rank, "coll": coll}))


def _run(health, wd, script):
    """Drive one monitor (rank 0 of 4) through ``script``: a list of
    (clock advance, {peer: (beat counter, step)}, action)."""
    store, clock, exits, saves = DictStore(), Clock(), [], []
    m = health.HealthMonitor(store, 0, 4, job_id="j", restart=0,
                             heartbeat_interval=1.0, heartbeat_timeout=5.0,
                             collective_deadline=3.0, straggler_skew=2,
                             clock=clock, final_save=lambda: saves.append(1),
                             exit_fn=exits.append, dump=False)
    m.set_step(10)
    ctx = None
    for dt, peers, action in script:
        clock.t += dt
        for r, (n, step) in peers.items():
            _peer(store, m.prefix, r, n, step)
        if action == "enter":
            ctx = m.collective("all_reduce")
            ctx.__enter__()
        elif action == "fail_flag":
            store.set(f"{m.prefix}/fail", pickle.dumps(
                {"reason": "boom", "rank": 3}))
        m.check()
    fail = store.get(f"{m.prefix}/fail")
    return {"kinds": [i["kind"] for i in wd.incidents()],
            "dead": sorted(m.dead), "stragglers": sorted(m.stragglers),
            "failed": m.failed, "exits": exits, "saves": len(saves),
            "fail_flag": pickle.loads(fail)["rank"] if fail else None,
            "beats": m.stats()["beats"], "lines": m.summary_lines()}


SCRIPTS = {
    "dead_peer": [(0, {1: (1, 10), 2: (1, 10), 3: (1, 10)}, None),
                  (3, {1: (2, 11), 2: (2, 11)}, None),
                  (3, {1: (3, 12), 2: (3, 12)}, None)],
    "straggler": [(0, {1: (1, 10), 2: (1, 10), 3: (1, 6)}, None),
                  (1, {1: (2, 11), 2: (2, 11), 3: (2, 9)}, None),
                  (1, {1: (3, 12), 2: (3, 12), 3: (3, 12)}, None)],
    "self_collective_timeout": [(0, {1: (1, 10)}, "enter"),
                                (2, {1: (2, 10)}, None),
                                (2, {1: (3, 10)}, None)],
    "peer_fail_flag": [(0, {1: (1, 10)}, None), (1, {}, "fail_flag")],
    "healthy": [(1, {1: (i, 10 + i), 2: (i, 10 + i), 3: (i, 10 + i)}, None)
                for i in range(1, 6)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_monitor_scripted_beside_the_reference(name):
    got = [_run(h, wd, SCRIPTS[name]) for h, wd in PAIRS]
    assert got[0] == got[1]
    if name != "healthy" and name != "straggler":
        assert got[1]["exits"] == [101] and got[1]["failed"]


def test_monitor_sees_a_peers_overdue_beacon(monkeypatch):
    outs = []
    for h, wd in PAIRS:
        wd.clear_incidents()
        store, exits = DictStore(), []
        m = h.HealthMonitor(store, 0, 2, job_id="j", restart=0,
                            collective_deadline=3.0, exit_fn=exits.append,
                            dump=False)
        now = time.time()
        _peer(store, m.prefix, 1, 1, 5,
              coll={"op": "all_reduce", "seq": 1, "since": now - 10.0})
        m.check()
        outs.append(([i["kind"] for i in wd.incidents()], exits, m.failed))
    assert outs[0] == outs[1]
    assert outs[1][0] == ["collective_timeout", "health_exit"]


def test_collectives_fire_the_beacon_and_the_chaos_point():
    store = DictStore()
    m = thealth.install(thealth.HealthMonitor(
        store, 0, 1, job_id="j", restart=0, collective_deadline=5.0,
        exit_fn=lambda c: None, dump=False))
    m.set_step(4)
    assert thealth.current_step() == 4 and thealth.monitored()
    x = torch.ones(3)
    assert C.all_reduce(x, group=ONE_RANK) is x
    assert m.stats()["beats"] == 2 and m._coll is None
    payload = pickle.loads(store.get(f"{m.prefix}/hb/0"))
    assert payload["coll"] is None and payload["step"] == 4
    with tchaos.installed("raise@collective.all_reduce:step=4"):
        with pytest.raises(tchaos.ChaosError):
            C.all_reduce(x, group=ONE_RANK)
    assert m._coll is None          # the beacon closed on the way out
    with tchaos.installed("raise@collective.all_gather:step=4"):
        with pytest.raises(tchaos.ChaosError):
            C.all_gather(x, ONE_RANK)
    thealth.uninstall()
    with tchaos.installed("raise@collective.all_reduce"):
        with pytest.raises(tchaos.ChaosError):   # no monitor: still fires
            C.all_reduce(x, group=ONE_RANK)


def test_incident_sidecars_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TPU_INCIDENT_DIR", str(tmp_path / "d"))
    monkeypatch.delenv("PADDLE_TPU_INCIDENTS_OUT", raising=False)
    recs = []
    for _, wd in PAIRS:
        wd.clear_incidents()
        assert wd.persist_incidents() is None        # nothing to write
        wd.record_incident("rank_dead", peer=2, silent_s=5.5)
        wd.record_incident("health_exit", reason="r", exit_code=101)
        path = wd.incident_sidecar_path()
        assert path == str(tmp_path / "d" / "incidents_rank3.jsonl")
        assert wd.persist_incidents() == path
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        for ln in lines:
            for k in ("time", "pid", "wall_time"):
                ln.pop(k, None)
        recs.append(lines)
        os.remove(path)
    assert recs[0] == recs[1]
    assert recs[1][0]["schema"] == "paddle_tpu.incidents.v1"


def test_chaos_gang_options_match_the_reference(monkeypatch):
    spec = ("kill@collective.all_reduce:step=3,rank=1,restart=0,resize=2;"
            "crash@ckpt.commit.pre:exit_code=7;truncate@x:frac=0.25;"
            "disconnect@store.get:times=2;sigterm@train.step:step=5")

    def key(c):
        return [(r.action, r.point, r.step, r.rank, r.restart, r.resize,
                 r.exit_code, r.frac, r.times) for r in c.rules]

    assert key(tchaos.Chaos(spec)) == key(jchaos.Chaos(spec))
    # rank= / restart= are read from the environment at fire time
    for rank, restart, fires in (("1", "0", True), ("0", "0", False),
                                 ("1", "1", False)):
        monkeypatch.setenv("PADDLE_TRAINER_ID", rank)
        monkeypatch.setenv("PADDLE_RESTART_COUNT", restart)
        c = tchaos.Chaos("raise@p:rank=1,restart=0")
        if fires:
            with pytest.raises(tchaos.ChaosError):
                c.hit("p")
        else:
            c.hit("p")
    with pytest.raises(ValueError):
        tchaos.set_kill_mode("explode")
    with pytest.raises(ValueError, match="resize"):
        tchaos.Rule("kill", "x", resize=0)
    c = tchaos.Chaos("disconnect@store.get:times=1")
    with pytest.raises(ConnectionResetError):
        c.hit("store.get")
    c.hit("store.get")
    monkeypatch.setenv("PTQ_CHAOS", "fail@a:step=2")
    assert tchaos.install_from_env() is tchaos.active()
    assert key(tchaos.active()) == key(jchaos.Chaos("fail@a:step=2"))


def test_process_kill_mode_exits_the_process():
    code = textwrap.dedent("""
        from paddle_tpu_torch.testing import chaos
        chaos.set_kill_mode("process")
        assert chaos.kill_mode() == "process"
        chaos.chaos_point("collective.all_reduce", step=3)
        print("SURVIVED")
    """)
    env = dict(os.environ, PTQ_CHAOS="kill@collective.all_reduce:step=3",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 42 and "SURVIVED" not in proc.stdout


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_classify_exit_equals_the_reference():
    for rc in (None, 0, 1, 101, -9, -15, 42):
        for esc in (False, True):
            assert tlaunch.classify_exit(rc, esc) == \
                jlaunch.classify_exit(rc, esc)
    assert [tlaunch.classify_exit(rc) for rc in (0, 101, -9, 1, None)] == \
        ["clean", "relaunch", "signal", "failed", "abandoned"]


def _script(tmp_path, body):
    p = tmp_path / "worker.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_elastic_pod_relaunches_on_101_for_free(tmp_path):
    script = _script(tmp_path, """
        import os, sys
        restart = int(os.environ["PADDLE_RESTART_COUNT"])
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        print("GEN", restart, rank, os.environ["PADDLE_TRAINERS_NUM"],
              flush=True)
        sys.exit(101 if restart < 2 and rank == 1 else 0)
    """)
    job = elastic.ElasticJob(script, [], 2, log_dir=str(tmp_path / "log"),
                             max_restarts=0, teardown_grace=2.0)
    try:
        assert job.run(poll_interval=0.05) == 0
    finally:
        job.close()
    assert job.restart_count == 2 and job._failures == 0
    with open(tmp_path / "log" / "workerlog.0") as f:
        gens = [ln.split()[1] for ln in f if ln.startswith("GEN")]
    assert gens == ["0", "1", "2"]


def test_pod_gives_up_after_max_restarts(tmp_path):
    script = _script(tmp_path, """
        import os, sys
        sys.exit(3 if os.environ["PADDLE_TRAINER_ID"] == "0" else 0)
    """)
    job = tlaunch.LocalJob(script, [], 2, log_dir=str(tmp_path / "log"),
                           max_restarts=2, teardown_grace=0.5)
    try:
        assert job.run(poll_interval=0.05) == 3
    finally:
        job.close()
    assert job.restart_count == 2
    with open(tmp_path / "log" / "pod_incidents.jsonl") as f:
        recs = [json.loads(ln) for ln in f][1:]
    teardown = [r for r in recs if r["kind"] == "pod_teardown"]
    assert teardown and {w["rank"]: w["class"] for w in
                         teardown[-1]["workers"]}[0] == "failed"


def test_heartbeat_stale_rank_is_killed(tmp_path):
    script = _script(tmp_path, """
        import time
        from paddle_tpu_torch.distributed.fleet.elastic import start_heartbeat
        start_heartbeat(0.1)
        time.sleep(120)
    """)
    env_chaos = "hang@elastic.heartbeat:after=2"
    code = textwrap.dedent(f"""
        import sys
        from paddle_tpu_torch.distributed.launch import main
        sys.exit(main(["--nproc_per_node", "1", "--max_restarts", "0",
                       "--heartbeat_timeout", "1.0",
                       "--teardown_grace", "0.2",
                       "--log_dir", {str(tmp_path / "log")!r},
                       {script!r}]))
    """)
    env = dict(os.environ, PTQ_CHAOS=env_chaos, PYTHONPATH=REPO)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=90)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "heartbeat-stale" in proc.stderr
    assert time.monotonic() - t0 < 60
    with open(tmp_path / "log" / "pod_incidents.jsonl") as f:
        recs = [json.loads(ln) for ln in f][1:]
    assert any("heartbeat-stale" in r.get("trigger", "") for r in recs)


def test_scale_request_respawns_the_pod_at_the_new_size(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO)
    script = _script(tmp_path, """
        import os, sys, time
        from paddle_tpu_torch.distributed.fleet.elastic import request_scale
        world = int(os.environ["PADDLE_TRAINERS_NUM"])
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        print("WORLD", world, flush=True)
        if world == 2:
            if rank == 0:
                request_scale(os.environ["PADDLE_MASTER"],
                              os.environ["PADDLE_JOB_ID"], 1)
            time.sleep(60)
    """)
    job = elastic.ElasticJob(script, [], 2, min_nproc=1, max_nproc=2,
                             log_dir=str(tmp_path / "log"), max_restarts=0,
                             job_id="scale")
    try:
        assert job.run(poll_interval=0.05) == 0
    finally:
        job.close()
    assert job.nproc == 1 and job.restart_count == 1
    with open(tmp_path / "log" / "workerlog.0") as f:
        assert [ln.split()[1] for ln in f if ln.startswith("WORLD")] == \
            ["2", "1"]
