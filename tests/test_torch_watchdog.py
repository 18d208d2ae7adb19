"""The port's hang watchdog (transformer_stm_tpu_torch/train/watchdog.py) and
``MultiTargetTrainer.fit(watchdog=...)`` on the CPU.

Every test of tests/test_watchdog.py, run against the port's module; its
names, values and environment variable equal to the JAX module's; the
port's trainer under a watchdog on the synthetic fixture of
``test_torch_data.write_fixture`` (the JAX test of ``fit`` reads the
reference checkout's data): a healthy fit trips nothing, a hung epoch trips
with its label, ``fit(watchdog=True)`` builds one from TSTM_WATCHDOG_S and
stops it, a caller's is started and left running.
"""

import os
import subprocess
import sys
import time

import pytest

from transformer_stm_tpu.train import watchdog as jax_watchdog
from transformer_stm_tpu_torch.train import watchdog as wd_mod
from transformer_stm_tpu_torch.train.multi import MultiTargetTrainer
from transformer_stm_tpu_torch.train.watchdog import (HangWatchdog,
                                                      STALL_EXIT_CODE,
                                                      watchdog_from_env)

from test_torch_data import write_fixture
from test_torch_multi import experiment

import transformer_stm_tpu_torch.config as pc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_and_values_match_jax():
    for name in ("STALL_EXIT_CODE", "PAUSE_FLAG", "PAUSE_FLAG_TTL_S"):
        assert getattr(wd_mod, name) == getattr(jax_watchdog, name), name
    assert STALL_EXIT_CODE == 75


def test_healthy_dispatches_never_trip():
    trips = []
    wd = HangWatchdog(timeout_s=0.5, first_timeout_s=0.5, poll_s=0.05,
                      on_stall=lambda: trips.append(1))
    with wd:
        for i in range(4):
            with wd.dispatch(f"step {i}"):
                time.sleep(0.05)
    assert not trips


def test_wedged_dispatch_trips():
    trips = []
    wd = HangWatchdog(timeout_s=0.2, first_timeout_s=0.2, poll_s=0.05,
                      on_stall=lambda: trips.append(1))
    with wd:
        with wd.dispatch("wedged"):
            time.sleep(0.6)   # outlives the deadline
    assert trips


def test_first_dispatch_gets_longer_deadline():
    trips = []
    wd = HangWatchdog(timeout_s=0.1, first_timeout_s=0.6, poll_s=0.05,
                      on_stall=lambda: trips.append(1))
    with wd:
        with wd.dispatch("first (device init)"):
            time.sleep(0.3)   # > timeout_s but < first_timeout_s
        assert not trips
        with wd.dispatch("second"):
            time.sleep(0.3)   # now past the steady-state deadline
    assert trips


def test_no_deadline_between_dispatches():
    trips = []
    wd = HangWatchdog(timeout_s=0.1, first_timeout_s=0.1, poll_s=0.05,
                      on_stall=lambda: trips.append(1))
    with wd:
        with wd.dispatch("quick"):
            pass
        time.sleep(0.4)   # host work between dispatches may take any time
    assert not trips


def test_env_factory(monkeypatch):
    monkeypatch.setenv("TSTM_WATCHDOG_S", "0")
    assert watchdog_from_env() is None
    monkeypatch.setenv("TSTM_WATCHDOG_S", "123")
    wd = watchdog_from_env()
    assert wd is not None and wd.timeout_s == 123.0
    monkeypatch.delenv("TSTM_WATCHDOG_S")
    assert watchdog_from_env(default_timeout=55).timeout_s == 55.0


def test_default_action_force_exits_process():
    """The default action ends a process whose main thread is blocked: the
    exit comes well before the sleep's end."""
    src = (
        "import time\n"
        "from transformer_stm_tpu_torch.train.watchdog import HangWatchdog\n"
        "wd = HangWatchdog(timeout_s=0.2, first_timeout_s=0.2,"
        " poll_s=0.05).start()\n"
        "with wd.dispatch('wedged'):\n"
        "    time.sleep(300)\n"
    )
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", src], timeout=240, cwd=ROOT,
                       capture_output=True, text=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert r.returncode == STALL_EXIT_CODE
    assert "'wedged' exceeded its deadline" in r.stderr
    assert time.time() - t0 < 150   # exited on the deadline, not the sleep


def test_stop_is_revivable():
    trips = []
    wd = HangWatchdog(timeout_s=0.2, first_timeout_s=0.2, poll_s=0.05,
                      on_stall=lambda: trips.append(1))
    wd.start()
    wd.stop()
    wd.start()
    with wd.dispatch("post-restart wedge"):
        time.sleep(0.6)
    wd.stop()
    assert trips


def test_fresh_pause_flag_freezes_countdown(tmp_path, monkeypatch):
    flag = tmp_path / "pause"
    flag.write_text("bench")
    monkeypatch.setattr(wd_mod, "PAUSE_FLAG", str(flag))

    trips = []
    wd = HangWatchdog(timeout_s=0.2, first_timeout_s=0.2, poll_s=0.05,
                      on_stall=lambda: trips.append(1))
    with wd:
        with wd.dispatch("paused, not wedged"):
            time.sleep(0.6)       # far past the deadline, flag fresh
            assert not trips
            flag.unlink()         # released
            time.sleep(0.5)       # countdown resumes and expires
    assert trips


# -- MultiTargetTrainer.fit(watchdog=...) -----------------------------------

@pytest.fixture
def trainer(tmp_path):
    fields, corpus = write_fixture(str(tmp_path))
    cfg = experiment(pc, fields, str(tmp_path), 8)
    return MultiTargetTrainer(cfg, [("50HZ_Bm", 0, None)], corpus=corpus,
                              device="cpu")


def _recording_watchdog(**kw):
    trips, logs = [], []
    wd = HangWatchdog(poll_s=0.05, on_stall=lambda: trips.append(1),
                      log=logs.append, **kw)
    return wd, trips, logs


def test_multi_trainer_fit_accepts_watchdog(trainer, tmp_path):
    """A healthy run completes without a trip, checkpoints included; the
    caller's watchdog is left running."""
    wd, trips, _ = _recording_watchdog(timeout_s=300, first_timeout_s=300)
    labels = []
    real = wd.dispatch
    wd.dispatch = lambda label: labels.append(label) or real(label)
    trainer.fit(2, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                verbose=False, watchdog=wd)
    assert trainer.epoch == 2 and not trips
    assert labels == ["corpus upload / device init", "multi-epoch @ 0",
                      "checkpoint @ 1", "multi-epoch @ 1", "checkpoint @ 2"]
    assert wd._thread is not None and wd._thread.is_alive()
    wd.stop()


def test_hung_epoch_trips_with_its_label(trainer, monkeypatch):
    wd, trips, logs = _recording_watchdog(timeout_s=0.2, first_timeout_s=30)
    real = MultiTargetTrainer.run_epoch

    def hung(self, epoch):
        time.sleep(0.8)
        return real(self, epoch)

    monkeypatch.setattr(MultiTargetTrainer, "run_epoch", hung)
    trainer.fit(1, verbose=False, watchdog=wd)
    wd.stop()
    assert trips == [1]
    assert "'multi-epoch @ 0' exceeded its deadline" in logs[0]


def test_fit_builds_and_stops_its_own_watchdog(trainer, monkeypatch):
    monkeypatch.setenv("TSTM_WATCHDOG_S", "300")
    made = []
    real = wd_mod.watchdog_from_env
    monkeypatch.setattr(wd_mod, "watchdog_from_env",
                        lambda *a: made.append(real(*a)) or made[-1])
    trainer.fit(1, verbose=False, watchdog=True)
    assert trainer.epoch == 1
    assert made[0].timeout_s == 300.0 and made[0]._thread is None
    monkeypatch.setenv("TSTM_WATCHDOG_S", "0")
    trainer.fit(2, verbose=False, watchdog=True)  # disabled: no watchdog
    assert trainer.epoch == 2 and made[1] is None
