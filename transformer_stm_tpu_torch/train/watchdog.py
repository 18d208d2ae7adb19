"""In-process hang watchdog (transformer_stm_tpu/train/watchdog.py:35-189).

A wedged device call raises nothing: the main thread waits forever inside
it, so no retry loop around the trainer ever runs.  The training loop
declares each blocking device call as a *dispatch* with a deadline, and a
daemon thread force-exits the process when one outlives it.  ``os._exit``
is the only reliable way out of a main thread blocked inside a CUDA call:
a SIGTERM handler runs on the main thread, which is the one that is stuck.
Checkpoint-resume (the stacked checkpoints of train/multi.py) makes the
exit lossless up to ``checkpoint_every`` epochs, and the supervisor
(train/supervisor.py) respawns the run.

    wd = HangWatchdog(timeout_s=720)
    wd.start()
    for epoch in ...:
        with wd.dispatch(f"epoch {epoch}"):   # deadline armed
            run_one_epoch()                    # ends in a sync with the card
    wd.stop()

CUDA launches return at once, so a deadline guards a wedge only if the
dispatch it brackets ends in a synchronisation with the card (a
``torch.cuda.synchronize``, or a copy of a result to the host).

Exit code 75 (BSD EX_TEMPFAIL) tells the supervisor "transient: retry".
The names, values and environment variables are the JAX package's, so that
one pause flag and one ``TSTM_WATCHDOG_S`` serve both packages.
"""

from __future__ import annotations

import os
import sys
import threading
import time

#: exit code of a watchdog force-exit (BSD EX_TEMPFAIL: transient failure,
#: the caller should retry)
STALL_EXIT_CODE = 75

#: A benchmark that SIGSTOPs an active trainer advertises the pause through
#: this flag file.  The watchdog's clock must not run during such a pause:
#: the monotonic clock keeps ticking while the process is stopped, so an
#: armed deadline would force-exit a healthy trainer once it is resumed.
PAUSE_FLAG = os.environ.get("TSTM_BENCH_PAUSE_FLAG", "/tmp/tstm_bench_pause")
PAUSE_FLAG_TTL_S = 2400.0


def _pause_flag_fresh() -> bool:
    try:
        return (time.time() - os.stat(PAUSE_FLAG).st_mtime) < PAUSE_FLAG_TTL_S
    except OSError:
        return False


class HangWatchdog:
    """Force-exits the process when a device dispatch outlives its deadline.

    A daemon thread checks every ``poll_s`` seconds whether a dispatch
    registered through :meth:`dispatch` has been in flight longer than
    ``timeout_s``.  Leaving the ``with`` block clears the deadline, so a
    healthy loop never trips it.  The first dispatch (device init, the
    kernels' build and first launches) gets ``first_timeout_s``.
    ``on_stall`` replaces the default action, ``os._exit(75)``.
    """

    def __init__(self, timeout_s: float = 720.0,
                 first_timeout_s: float = None, poll_s: float = 15.0,
                 on_stall=None, log=None):
        self.timeout_s = float(timeout_s)
        self.first_timeout_s = float(first_timeout_s
                                     if first_timeout_s is not None
                                     else max(timeout_s, 600.0))
        self.poll_s = float(poll_s)
        self._deadline = None          # monotonic deadline or None
        self._label = ""
        self._first = True
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._on_stall = on_stall or self._default_stall
        self._log = log or (lambda msg: print(msg, file=sys.stderr,
                                              flush=True))

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tstm-hang-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)
            self._thread = None
        # a stopped watchdog can be started again: MultiTargetTrainer.fit
        # brackets only its own phase, and the same instance then guards
        # the export and evaluation dispatches
        self._stop = threading.Event()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- the deadline -------------------------------------------------------

    def dispatch(self, label: str = "dispatch"):
        """Context manager arming the deadline around one blocking device
        call (an epoch chunk, a validation sweep, a checkpoint fetch)."""
        return _Dispatch(self, label)

    def _arm(self, label: str):
        with self._lock:
            t = self.first_timeout_s if self._first else self.timeout_s
            self._deadline = time.monotonic() + t
            self._label = label

    def _disarm(self):
        with self._lock:
            self._deadline = None
            self._first = False

    # -- the thread ---------------------------------------------------------

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                d, label = self._deadline, self._label
            if d is not None and _pause_flag_fresh():
                # the trainer is paused on purpose: push the deadline along
                # with the poll clock instead of letting it expire
                with self._lock:
                    if self._deadline is not None:
                        self._deadline += self.poll_s
                continue
            if d is not None and time.monotonic() > d:
                self._log(f"[watchdog] '{label}' exceeded its deadline — "
                          f"device wedged; exiting {STALL_EXIT_CODE} for "
                          f"a checkpoint-resume restart")
                self._on_stall()
                return

    @staticmethod
    def _default_stall():
        # Flush what can be flushed and leave without atexit handlers or
        # finalisers (os._exit, not sys.exit).  Nothing here touches CUDA:
        # the main thread may be blocked inside a CUDA call, and a
        # synchronise or an allocator call from this thread could block too.
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:
            pass
        os._exit(STALL_EXIT_CODE)


class _Dispatch:
    def __init__(self, wd: HangWatchdog, label: str):
        self._wd = wd
        self._label = label

    def __enter__(self):
        self._wd._arm(self._label)
        return self

    def __exit__(self, *exc):
        self._wd._disarm()


def watchdog_from_env(default_timeout: float = 720.0) -> "HangWatchdog | None":
    """A watchdog from TSTM_WATCHDOG_S (seconds; '0' disables), or None
    when disabled."""
    raw = os.environ.get("TSTM_WATCHDOG_S", "")
    if raw == "0":
        return None
    try:
        timeout = float(raw) if raw else default_timeout
    except ValueError:
        timeout = default_timeout
    return HangWatchdog(timeout_s=timeout)
