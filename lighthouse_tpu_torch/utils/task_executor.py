"""TaskExecutor — supervised task spawning with exit signaling.

Parity surface: lighthouse/common/task_executor/src/lib.rs — every
long-running service runs under an executor that (a) hands tasks an exit
signal to watch, (b) logs task completion, and (c) on a task PANIC triggers
a graceful whole-process shutdown rather than limping along with a dead
critical service (lib.rs:134-146). Python translation: threads + an Event
exit signal + a shutdown callback on unhandled exception.

Also here: Lockfile (common/lockfile) — exclusive datadir ownership via an
O_EXCL pidfile with stale-lock takeover."""

from __future__ import annotations

import os
import threading
import traceback


class TaskExecutor:
    def __init__(self, name: str = "executor", on_fatal=None, log=None):
        self.name = name
        self.exit_signal = threading.Event()
        self.on_fatal = on_fatal
        self.log = log or (lambda msg: None)
        self._threads: list[threading.Thread] = []
        self.panicked: str | None = None

    def spawn(self, fn, name: str, *args, critical: bool = True, **kwargs) -> threading.Thread:
        """Run fn(*args, exit_signal=..., **kwargs) in a supervised thread.
        If a CRITICAL task dies with an exception, the executor fires the
        exit signal and the fatal callback (panic => shutdown)."""

        def runner():
            try:
                fn(*args, exit_signal=self.exit_signal, **kwargs)
                self.log(f"task {name} exited cleanly")
            except Exception:  # noqa: BLE001 — supervision boundary
                self.panicked = name
                self.log(f"task {name} PANICKED:\n{traceback.format_exc()}")
                if critical:
                    self.shutdown(reason=f"critical task {name} panicked")

        t = threading.Thread(target=runner, name=f"{self.name}/{name}", daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def shutdown(self, reason: str = "requested") -> None:
        if not self.exit_signal.is_set():
            self.log(f"shutdown: {reason}")
            self.exit_signal.set()
            if self.on_fatal is not None:
                self.on_fatal(reason)

    def join(self, timeout: float = 5.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout)


class LockfileError(Exception):
    pass


class Lockfile:
    """Exclusive datadir lock (common/lockfile/src/lib.rs): an O_EXCL
    pidfile; a leftover file from a DEAD pid is taken over, a LIVE pid is a
    hard error (two nodes on one datadir is how slashing happens)."""

    def __init__(self, path: str):
        self.path = path
        self._held = False

    def acquire(self) -> None:
        import fcntl

        # The check-stale/unlink/create sequence must be atomic across
        # processes or two simultaneous starters can BOTH take over a stale
        # lock (A unlinks B's fresh lock after B replaced the stale one).
        # An flock on a side guard file serializes the whole attempt.
        guard = os.open(self.path + ".guard", os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(guard, fcntl.LOCK_EX)
            while True:
                try:
                    fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.write(fd, str(os.getpid()).encode())
                    os.close(fd)
                    self._held = True
                    return
                except FileExistsError:
                    try:
                        with open(self.path) as f:
                            pid = int(f.read().strip() or "0")
                    except (OSError, ValueError):
                        pid = 0
                    if pid and _pid_alive(pid):
                        raise LockfileError(
                            f"{self.path} held by live pid {pid}"
                        ) from None
                    # stale lock: remove and retry (still under the guard)
                    try:
                        os.unlink(self.path)
                    except OSError:
                        pass
        finally:
            try:
                fcntl.flock(guard, fcntl.LOCK_UN)
            finally:
                os.close(guard)

    def release(self) -> None:
        if self._held:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self._held = False

    def __enter__(self) -> "Lockfile":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
