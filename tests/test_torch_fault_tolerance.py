"""The port's commit protocol, preemption and retries against the JAX
package's (``paddle_tpu.distributed.fault_tolerance``), and its
crash-consistent ``framework.io``.

The same directory operations run through both modules: manifests must
be equal but for the framework version, each ``verify_dir`` must accept
the other's committed directories and reject the same truncations,
flipped bytes, missing files and leftover tmp directories, and
``recover_dir``, ``prune_steps`` and pins must leave the same step sets.
Comparisons are exact (file sets, manifests, seeded delays).
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest
import torch

from paddle_tpu.distributed import fault_tolerance as jft
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import fault_tolerance as tft
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.testing import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (jft, tft)


@pytest.fixture(autouse=True)
def _clean():
    yield
    tchaos.uninstall()
    jchaos.uninstall()
    for m in BOTH:
        m.reset_stats()


def _payload(d, files=(("w.bin", b"x" * 64), ("sub/o.bin", b"yz" * 40))):
    for name, data in files:
        p = os.path.join(d, name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)


def _tree(d):
    """Every file under ``d`` with its bytes, relative paths."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_constants_and_relaunch_code_match():
    for name in ("RELAUNCH_EXIT_CODE", "MANIFEST_NAME", "TMP_SUFFIX",
                 "OLD_SUFFIX"):
        assert getattr(tft, name) == getattr(jft, name)
    assert tft.RELAUNCH_EXIT_CODE == 101
    assert tft.step_dir_name(7) == jft.step_dir_name(7) == "step_00000007"


def test_manifests_equal_but_for_the_version(tmp_path):
    mans = []
    for m in BOTH:
        d = str(tmp_path / m.__name__.split(".")[0] / "ck")
        _payload(d)
        mans.append(m.write_manifest(d, extra={"step": 3, "x": [1, 2]}))
        with open(os.path.join(d, m.MANIFEST_NAME)) as f:
            assert json.load(f) == mans[-1]
    j, t = (dict(x) for x in mans)
    assert j.pop("framework_version") != t.pop("framework_version")
    assert j == t
    assert t["bytes_total"] == 64 + 80 and t["step"] == 3


@pytest.mark.parametrize("writer,reader", [(jft, tft), (tft, jft)],
                         ids=["jax_commits", "port_commits"])
def test_verify_dir_accepts_the_other_packages_commit(tmp_path, writer,
                                                      reader):
    root = str(tmp_path)
    tmp = os.path.join(root, "step_00000002" + writer.TMP_SUFFIX)
    final = os.path.join(root, "step_00000002")
    _payload(tmp)
    writer.commit_dir(tmp, final, extra={"step": 2})
    man = reader.verify_dir(final)
    assert man["step"] == 2 and reader.is_committed(final)
    assert reader.committed_steps(root) == [2]
    assert reader.latest_committed_step(root) == 2


def _damage(kind, d, chaos_mod):
    w = os.path.join(d, "w.bin")
    if kind == "truncated":
        chaos_mod.truncate_file(w, keep_frac=0.5)
    elif kind == "flipped":
        chaos_mod.corrupt_file(w, nbytes=4, seed=3)
    elif kind == "missing":
        os.remove(os.path.join(d, "sub", "o.bin"))
    elif kind == "no_manifest":
        os.remove(os.path.join(d, jft.MANIFEST_NAME))


@pytest.mark.parametrize("kind", ["truncated", "flipped", "missing",
                                  "no_manifest"])
def test_both_reject_the_same_damage(tmp_path, kind):
    errs = []
    for writer in BOTH:
        for reader in BOTH:
            d = str(tmp_path / f"{writer.__name__}{reader.__name__}")
            _payload(d)
            writer.write_manifest(d, extra={"step": 1})
            _damage(kind, d, jchaos if writer is jft else tchaos)
            with pytest.raises(reader.CheckpointCorruptionError) as e:
                reader.verify_dir(d)
            errs.append(str(e.value).replace(d, "D"))
    # the two readers say the same thing about the same damage
    assert errs[0] == errs[1] and errs[2] == errs[3]


def test_corruption_helpers_flip_the_same_bytes(tmp_path):
    data = bytes(range(256)) * 4
    out = []
    for m in (jchaos, tchaos):
        p = str(tmp_path / m.__name__)
        with open(p, "wb") as f:
            f.write(data)
        m.corrupt_file(p, nbytes=8, seed=5)
        with open(p, "rb") as f:
            flipped = f.read()
        m.truncate_file(p, keep_frac=0.25)
        out.append((flipped, os.path.getsize(p)))
    assert out[0] == out[1] and out[0][0] != data and out[0][1] == 256


def _recover_scenario(m, root, kind):
    path = os.path.join(root, "ck")
    tmp, old = path + m.TMP_SUFFIX, path + m.OLD_SUFFIX
    if kind in ("final_wins", "tmp_rolls_forward", "husk_loses"):
        _payload(tmp, (("w.bin", b"new"),))
        m.write_manifest(tmp)
    if kind == "final_wins":
        _payload(path, (("w.bin", b"cur"),))
        m.write_manifest(path)
        _payload(old, (("w.bin", b"old"),))
    if kind == "husk_loses":
        _payload(path, (("w.bin", b"torn"),))
    if kind in ("old_rolls_back", "uncommitted"):
        if kind == "old_rolls_back":
            _payload(old, (("w.bin", b"old"),))
            m.write_manifest(old)
        _payload(path, (("w.bin", b"torn"),))
    try:
        got = m.recover_dir(path)
        res = ("ok", os.path.basename(got))
    except FileNotFoundError:
        res = ("missing",)
    except m.CheckpointCorruptionError:
        res = ("corrupt",)
    listing = sorted(os.listdir(root))
    files = {k: v for k, v in _tree(root).items()
             if not k.endswith(m.MANIFEST_NAME)}
    return res, listing, files


@pytest.mark.parametrize("kind", ["final_wins", "tmp_rolls_forward",
                                  "husk_loses", "old_rolls_back",
                                  "uncommitted", "nothing"])
def test_recover_dir_leaves_the_same_state(tmp_path, kind):
    outs = []
    for m in BOTH:
        root = str(tmp_path / m.__name__)
        os.makedirs(root)
        outs.append(_recover_scenario(m, root, kind))
    assert outs[0] == outs[1]


def test_prune_and_pins_leave_the_same_steps(tmp_path):
    outs = []
    for m in BOTH:
        root = str(tmp_path / m.__name__)
        for s in range(1, 8):
            d = os.path.join(root, m.step_dir_name(s))
            _payload(d, (("w.bin", b"%d" % s),))
            if s != 5:              # step 5 never committed
                m.write_manifest(d)
        for s in (8, 9):            # crash leftovers and an async save
            _payload(os.path.join(root, m.step_dir_name(s) + m.TMP_SUFFIX))
        m.pin_step(root, 2)
        removed = m.prune_steps(root, keep=2, inflight=[9])
        after = sorted(os.listdir(root))
        m.unpin_step(root, 2)
        removed2 = m.prune_steps(root, keep=1)
        outs.append((removed, after, removed2, sorted(os.listdir(root)),
                     m.committed_steps(root), sorted(m.pinned_steps(root))))
    assert outs[0] == outs[1]
    assert outs[1][0] == [1, 3, 4] and outs[1][4] == [7]


def test_backoff_delays_and_retries_are_equal():
    import random
    for kw in (dict(), dict(base=0.1, factor=3.0, max_delay=1.0),
               dict(jitter=0.0)):
        got = [list(m.backoff_delays(6, rng=random.Random(4), **kw))
               for m in BOTH]
        assert got[0] == got[1]
    logs = []
    for m in BOTH:
        calls, sleeps, seen = [], [], []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionResetError("flaky")
            return "done"

        out = m.retry_with_backoff(
            fn, attempts=4, sleep=sleeps.append, rng=random.Random(1),
            on_retry=lambda a, e, d: seen.append((a, type(e).__name__)))
        with pytest.raises(ValueError):
            m.retry_with_backoff(lambda: (_ for _ in ()).throw(
                ValueError("no")), sleep=sleeps.append)
        logs.append((out, len(calls), sleeps, seen, m.stats()["retries"]))
    assert logs[0] == logs[1]


def test_checkpoint_manager_pickle_backend_falls_back_like_jax(tmp_path):
    import numpy as np
    outs = []
    for m, make in ((jft, lambda v: {"w": np.full(4, v, np.float32)}),
                    (tft, lambda v: {"w": torch.full((4,), v)})):
        root = str(tmp_path / m.__name__)
        mgr = m.CheckpointManager(root, backend="pickle", keep=2,
                                  track_rng=False)
        for s in (1, 2, 3):
            mgr.save(s, make(float(s)))
        (jchaos if m is jft else tchaos).truncate_file(
            os.path.join(root, m.step_dir_name(3), mgr.state_file))
        state, got = mgr.restore()
        w = state["w"]
        w = np.asarray(getattr(w, "_array", w))
        outs.append((got, w.tolist(), mgr.all_steps(), m.stats()["fallbacks"],
                     m.stats()["saves"], m.stats()["restores"],
                     sorted(m.pinned_steps(root))))
    assert outs[0] == outs[1]
    assert outs[1][:2] == (2, [2.0] * 4)


def test_checkpoint_metrics_and_summary_match(tmp_path):
    from paddle_tpu.core import flags as jflags
    from paddle_tpu.profiler import metrics as jmetrics
    snaps, lines = [], []
    for m, fl, met in ((jft, jflags, jmetrics), (tft, tflags, tmetrics)):
        met.reset()
        fl.set_flags({"FLAGS_tpu_metrics": True})
        try:
            m.record_save(0.5, 1000, step=4)
            m.record_save(0.25, 24, step=6)
            m.record_restore(6)
            m.record_fallback(6)
            snap = met.snapshot()
        finally:
            fl.set_flags({"FLAGS_tpu_metrics": False})
            met.reset()
        snaps.append({k: v for k, v in snap.items()
                      if k.startswith("ckpt_") and "seconds" not in k})
        lines.append(m.summary_lines())
    assert snaps[0] == snaps[1] and snaps[1]["ckpt_bytes_total"] == 1024
    assert lines[0] == lines[1]


def test_sigterm_in_a_subprocess_commits_and_exits_101(tmp_path):
    root = str(tmp_path / "ck")
    script = textwrap.dedent(f"""
        import torch
        from paddle_tpu_torch.distributed.fault_tolerance import (
            CheckpointManager)
        from paddle_tpu_torch.testing.chaos import chaos_point
        mgr = CheckpointManager({root!r}, backend="pickle", keep=0,
                                save_interval_steps=100, preemption=True)
        w = torch.zeros(3)
        for step in range(1, 10):
            w = w + 1
            chaos_point("train.step", step=step)   # sigterm at step 3
            mgr.step_end(step, {{"w": w}})
        print("NOT PREEMPTED")
    """)
    env = dict(os.environ, PTQ_CHAOS="sigterm@train.step:step=3",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == tft.RELAUNCH_EXIT_CODE, proc.stderr[-2000:]
    assert "NOT PREEMPTED" not in proc.stdout
    assert tft.committed_steps(root) == [3]
    state = tio.load(os.path.join(root, "step_00000003", "state.pdz"))
    assert torch.equal(state["w"], torch.full((3,), 3.0))


def test_preemption_handler_latches_and_restores_the_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with tft.PreemptionHandler(signals=(signal.SIGTERM,)) as h:
        assert not h.requested() and tft.stats()["preemption_armed"]
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested() and tft.stats()["preemption_requested"]
        with pytest.raises(SystemExit) as e:
            h.exit_for_relaunch()
        assert e.value.code == 101
    assert signal.getsignal(signal.SIGTERM) is prev


# ---------------------------------------------------------------------------
# framework.io
# ---------------------------------------------------------------------------

def test_io_round_trip_keeps_dtypes_and_structure(tmp_path):
    p = str(tmp_path / "s.pdz")
    tree = {"a": torch.randn(5, 3).to(torch.bfloat16),
            "b": [torch.arange(4), (1.5, "x")], "c": {"d": None, "n": 7},
            "step": torch.tensor(9.0)}
    tio.save(tree, p)
    got = tio.load(p)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                            tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0])
    assert got["b"][1] == (1.5, "x") and got["c"] == {"d": None, "n": 7}
    assert not [f for f in os.listdir(tmp_path) if "ptq-tmp" in f]


def test_io_truncated_file_raises_naming_it(tmp_path):
    p = str(tmp_path / "s.pdz")
    tio.save({"w": torch.ones(1000)}, p)
    tchaos.truncate_file(p, keep_frac=0.5)
    with pytest.raises(RuntimeError, match="s.pdz"):
        tio.load(p)


def test_io_crash_before_commit_keeps_the_previous_file(tmp_path):
    p = str(tmp_path / "s.pdz")
    tio.save({"w": torch.ones(3)}, p)
    with tchaos.installed("raise@io.save.pre_commit"):
        with pytest.raises(tchaos.ChaosError):
            tio.save({"w": torch.zeros(3)}, p)
    assert torch.equal(tio.load(p)["w"], torch.ones(3))
    assert os.listdir(tmp_path) == ["s.pdz"]


def test_a_save_that_does_not_fit_is_refused_up_front(tmp_path,
                                                      monkeypatch):
    import shutil as _shutil
    from collections import namedtuple
    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(_shutil, "disk_usage",
                        lambda p: usage(1 << 30, 0, 4096))
    mgr = tft.CheckpointManager(str(tmp_path), backend="pickle")
    with pytest.raises(OSError, match="4000000 bytes"):
        mgr.save(1, {"w": torch.zeros(1_000_000)})
    assert os.listdir(tmp_path) == []
    assert tft.tree_bytes({"a": torch.zeros(3, dtype=torch.bfloat16),
                           "b": [torch.zeros(2)]}) == 14
