"""The port's run supervisor (transformer_stm_tpu_torch/train/supervisor.py)
on the CPU: every test of tests/test_supervisor.py against the port's
module (respawn until done, attempt accounting, the completion marker, the
pid-exact SIGCONT failsafe and the pause flag, the command line, SIGTERM
forwarding), its marker equal to the JAX module's, and a respawned child
resumed: a child that the port's watchdog force-exits with 75 is respawned
and finishes.  Also the import hygiene of the run tooling's seven modules:
no import of jax or of the JAX package, and each imports with jax
blocked."""

import ast
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from transformer_stm_tpu.train import supervisor as jax_supervisor
from transformer_stm_tpu_torch.train import watchdog as wd_mod
from transformer_stm_tpu_torch.train.supervisor import (COMPLETION_MARKER,
                                                        supervise)
from transformer_stm_tpu_torch.train.watchdog import STALL_EXIT_CODE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_script(tmp_path, body):
    path = tmp_path / "child.py"
    path.write_text(textwrap.dedent(body))
    return [sys.executable, str(path)]


def test_marker_matches_jax():
    assert COMPLETION_MARKER == jax_supervisor.COMPLETION_MARKER


def test_retries_stall_exits_until_success(tmp_path):
    """Two 75 exits, then success: three attempts, marker written, rc 0."""
    state = tmp_path / "attempts"
    log = tmp_path / "sup.log"
    cmd = _child_script(tmp_path, f"""
        import os, sys
        p = {str(state)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        print("child attempt", n + 1)
        sys.exit({STALL_EXIT_CODE} if n < 2 else 0)
    """)
    rc = supervise(cmd, max_attempts=10, retry_delay_s=0.05,
                   log_path=str(log))
    assert rc == 0
    assert state.read_text() == "3"
    text = log.read_text()
    assert COMPLETION_MARKER in text
    assert text.count("supervisor attempt") == 3
    assert "watchdog stall" in text          # 75 is named, not just a code
    assert "child attempt 2" in text         # child output lands in the log


def test_gives_up_after_max_attempts(tmp_path):
    log = tmp_path / "sup.log"
    cmd = _child_script(tmp_path, "import sys; sys.exit(3)\n")
    rc = supervise(cmd, max_attempts=3, retry_delay_s=0.05,
                   log_path=str(log))
    assert rc == 3
    text = log.read_text()
    assert COMPLETION_MARKER not in text
    assert "=== supervisor: exit 3; attempts exhausted ===" in text
    assert text.count("supervisor attempt") == 3


def test_watchdog_force_exit_is_respawned(tmp_path):
    """A child whose first attempt wedges under the port's watchdog exits
    75; the supervisor logs the stall and the second attempt finishes."""
    marker = tmp_path / "attempted"
    log = tmp_path / "sup.log"
    cmd = _child_script(tmp_path, f"""
        import os, sys, time
        sys.path.insert(0, {ROOT!r})
        from transformer_stm_tpu_torch.train.watchdog import HangWatchdog
        wd = HangWatchdog(timeout_s=0.2, first_timeout_s=0.2,
                          poll_s=0.05).start()
        first = not os.path.exists({str(marker)!r})
        open({str(marker)!r}, "a").write("x")
        with wd.dispatch("multi-epoch @ 10"):
            time.sleep(300 if first else 0.01)
        print("finished")
    """)
    rc = supervise(cmd, max_attempts=3, retry_delay_s=0.05,
                   log_path=str(log),
                   env={"PYTHONDONTWRITEBYTECODE": "1"})
    text = log.read_text()
    assert rc == 0, text
    assert marker.read_text() == "xx"
    assert "'multi-epoch @ 10' exceeded its deadline" in text
    assert "=== supervisor: watchdog stall; retry in 0s ===" in text
    assert "finished" in text and COMPLETION_MARKER in text


def test_sigcont_failsafe_resumes_stopped_child(tmp_path):
    """A child that SIGSTOPs itself is resumed by the supervisor's own-pid
    failsafe and then completes."""
    log = tmp_path / "sup.log"
    cmd = _child_script(tmp_path, """
        import os, signal
        os.kill(os.getpid(), signal.SIGSTOP)
        print("resumed")
    """)
    t0 = time.time()
    rc = supervise(cmd, max_attempts=1, retry_delay_s=0.05,
                   log_path=str(log), cont_poll_s=0.2)
    assert rc == 0
    assert time.time() - t0 < 30
    text = log.read_text()
    assert "failsafe: SIGCONT" in text
    assert "resumed" in text


def test_pause_flag_holds_failsafe_off(tmp_path, monkeypatch):
    """While the pause flag is fresh the failsafe does not resume a stopped
    child; deleting the flag releases it."""
    flag = tmp_path / "pause_flag"
    flag.write_text("bench")
    # _pause_flag_fresh() reads watchdog.PAUSE_FLAG
    monkeypatch.setattr(wd_mod, "PAUSE_FLAG", str(flag))

    log = tmp_path / "sup.log"
    cmd = _child_script(tmp_path, """
        import os, signal
        os.kill(os.getpid(), signal.SIGSTOP)
        print("resumed")
    """)
    result = {}

    def run():
        result["rc"] = supervise(cmd, max_attempts=1, retry_delay_s=0.05,
                                 log_path=str(log), cont_poll_s=0.2)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(2.0)   # ~10 failsafe polls with the flag fresh
    assert "rc" not in result, "child resumed despite a fresh pause flag"
    assert "failsafe: SIGCONT" not in log.read_text()
    flag.unlink()
    t.join(timeout=30)
    assert not t.is_alive()
    assert result.get("rc") == 0
    assert "resumed" in log.read_text()


def test_cli_entry(tmp_path):
    log = tmp_path / "sup.log"
    out = subprocess.run(
        [sys.executable, "-m", "transformer_stm_tpu_torch.train.supervisor",
         "--max-attempts", "2", "--retry-delay", "0.05",
         "--log", str(log), "--",
         sys.executable, "-c", "print('ok')"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr
    text = log.read_text()
    assert COMPLETION_MARKER in text and "ok" in text


def test_sigterm_terminates_child(tmp_path):
    """SIGTERM on the supervisor terminates the child and exits 128 + 15."""
    marker = tmp_path / "started"
    log = tmp_path / "sup.log"
    child = _child_script(tmp_path, f"""
        import time, pathlib
        pathlib.Path({str(marker)!r}).touch()
        time.sleep(300)
    """)
    sup = subprocess.Popen(
        [sys.executable, "-m", "transformer_stm_tpu_torch.train.supervisor",
         "--log", str(log), "--"] + child, cwd=ROOT,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    for _ in range(600):
        if marker.exists():
            break
        time.sleep(0.1)
    assert marker.exists()
    sup.send_signal(signal.SIGTERM)
    assert sup.wait(timeout=30) == 128 + signal.SIGTERM
    time.sleep(0.5)
    children = subprocess.run(
        ["ps", "-eo", "args="], capture_output=True, text=True).stdout
    assert str(tmp_path / "child.py") not in children


RUN_TOOLING = ["train.watchdog", "train.supervisor", "train.many",
               "train.sweep", "debug", "tools.profiling", "tools.tb_export"]


@pytest.mark.parametrize("name", RUN_TOOLING)
def test_run_tooling_imports_nothing_of_jax(name):
    """No import statement of the module names jax or the JAX package."""
    path = os.path.join(ROOT, "transformer_stm_tpu_torch",
                        *name.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib",
                                           "transformer_stm_tpu"), (name, n)


def test_run_tooling_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for name in {RUN_TOOLING!r}:\n"
            "    importlib.import_module('transformer_stm_tpu_torch.' + name)\n"
            "bad = [m for m in sys.modules if m == 'transformer_stm_tpu'\n"
            "       or m.startswith('transformer_stm_tpu.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr
