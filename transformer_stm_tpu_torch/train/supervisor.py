r"""Run supervisor (transformer_stm_tpu/train/supervisor.py:51-198):
respawn a training command until it exits 0.

The in-process watchdog (train/watchdog.py) turns a wedged device call into
exit code 75; this module owns the retry.  Each respawn resumes from the
latest stacked checkpoint (train/multi.py), so it loses at most
``checkpoint_every`` epochs.  The supervisor is a separate process from the
trainer: a trainer blocked inside a CUDA call can only leave through
``os._exit``, which would take an in-process supervisor with it.

Also owned here, by pid and never by pattern: the SIGCONT failsafe.  A
benchmark may SIGSTOP an active trainer for a clean measurement and resume
it when it ends, but a benchmark that is killed cannot.  The supervisor
polls its own child's /proc state and SIGCONTs it if it stays stopped
across two polls (SIGCONT to a running process does nothing), unless the
pause flag (``watchdog.PAUSE_FLAG``) is fresh.

    python -m transformer_stm_tpu_torch.train.supervisor \
        --log run.log -- \
        python -m transformer_stm_tpu_torch.train.many 50HZ_Bm 1000 8

The log carries the JAX supervisor's markers ("=== supervisor: run
completed ===" on success) and exit codes.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time

from .watchdog import STALL_EXIT_CODE, _pause_flag_fresh

#: the line a run's success is recognised by (keep stable)
COMPLETION_MARKER = "=== supervisor: run completed ==="


def _utcnow() -> str:
    return time.strftime("%H:%M:%S", time.gmtime())


class _ContFailsafe:
    """Daemon thread that SIGCONTs the supervised child if it stays in a
    stopped (T) state across two consecutive polls."""

    def __init__(self, poll_s: float = 150.0, log=None):
        self.poll_s = poll_s
        self._log = log or (lambda msg: None)
        self._pid = None
        self._stop = threading.Event()
        self._was_stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def watch(self, pid: int | None):
        self._pid = pid
        self._was_stopped = False

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    @staticmethod
    def _state(pid: int) -> str:
        try:
            with open(f"/proc/{pid}/stat") as f:
                # field 3, after the parenthesised command name, which may
                # itself hold spaces: split on the last ')'
                return f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            return "?"

    def _run(self):
        while not self._stop.wait(self.poll_s):
            pid = self._pid
            if pid is None:
                continue
            stopped = self._state(pid) == "T"
            if stopped and _pause_flag_fresh():
                # a benchmark holds the trainer for a clean measurement
                self._was_stopped = False
                continue
            if stopped and self._was_stopped:
                try:
                    os.kill(pid, signal.SIGCONT)
                    self._log(f"failsafe: SIGCONT {pid} (stopped two "
                              f"polls) {_utcnow()}")
                except OSError:
                    pass
            self._was_stopped = stopped


def supervise(cmd, *, max_attempts: int = 200, retry_delay_s: float = 120.0,
              log_path: str | None = None, env: dict | None = None,
              cont_poll_s: float = 150.0) -> int:
    """Runs ``cmd`` (an argv list) until it exits 0; respawns it on any
    failure, after ``retry_delay_s``.

    Exit code :data:`~.watchdog.STALL_EXIT_CODE` (75) marks a watchdog
    force-exit and is logged as "watchdog stall"; every other nonzero code
    is retried the same way, because checkpoint-resume makes a blind retry
    cheap and correct.  Returns the last exit code (0 on success).  SIGTERM
    to the supervisor terminates the child and exits 128 + 15.
    """
    logf = open(log_path, "a", buffering=1) if log_path else sys.stdout

    def log(msg):
        print(msg, file=logf, flush=True)

    failsafe = _ContFailsafe(poll_s=cont_poll_s, log=log)
    failsafe.start()
    child = None

    def _forward_term(signum, frame):
        if child is not None and child.poll() is None:
            child.terminate()
        raise SystemExit(128 + signum)

    try:
        old_term = signal.signal(signal.SIGTERM, _forward_term)
    except ValueError:          # not the main thread
        old_term = None
    rc = 1
    try:
        for attempt in range(1, max_attempts + 1):
            log(f"=== supervisor attempt {attempt} {_utcnow()} ===")
            child = subprocess.Popen(
                cmd, stdout=logf if log_path else None,
                stderr=subprocess.STDOUT if log_path else None,
                env={**os.environ, **(env or {})})
            failsafe.watch(child.pid)
            rc = child.wait()
            failsafe.watch(None)
            if rc == 0:
                log(COMPLETION_MARKER)
                return 0
            kind = ("watchdog stall" if rc == STALL_EXIT_CODE
                    else f"exit {rc}")
            if attempt == max_attempts:
                log(f"=== supervisor: {kind}; attempts exhausted ===")
                return rc
            log(f"=== supervisor: {kind}; retry in "
                f"{retry_delay_s:.0f}s ===")
            time.sleep(retry_delay_s)
        return rc
    finally:
        failsafe.stop()
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
        if log_path:
            logf.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Respawn a training command until it exits 0 "
                    "(checkpoint-resume makes retries lossless).")
    p.add_argument("--max-attempts", type=int, default=200)
    p.add_argument("--retry-delay", type=float, default=120.0)
    p.add_argument("--log", default=None,
                   help="append supervisor + child output here "
                        "(default: stdout)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the training command")
    args = p.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given (pass it after --)")
    return supervise(cmd, max_attempts=args.max_attempts,
                     retry_delay_s=args.retry_delay, log_path=args.log)


if __name__ == "__main__":
    sys.exit(main())
