"""File-lock leader election.

Reference analog: controller-runtime's Lease-based leader election enabled by
``--leader-elect`` with ID ``c5744f42.hpsys.ibm.ie.com`` (cmd/main.go:142-155).
Standalone deployments get the same single-active-manager guarantee from an
fcntl advisory lock on a well-known path; when running against a real K8s API
a Lease implementation can be slotted in behind the same interface.
"""

from __future__ import annotations

import fcntl
import os
import threading
from typing import Optional

LEADER_ELECTION_ID = "c5744f42.tpu.composer.dev"


class LeaderElector:
    def __init__(self, lock_path: Optional[str] = None) -> None:
        self.lock_path = lock_path or os.path.join(
            os.environ.get("TPUC_RUN_DIR", "/tmp"), f"{LEADER_ELECTION_ID}.lock"
        )
        self._fd: Optional[int] = None
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            if self._fd is not None:
                return True
            fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                return False
            os.ftruncate(fd, 0)
            os.write(fd, str(os.getpid()).encode())
            self._fd = fd
            return True

    def acquire(self, poll_interval: float = 0.5, stop_event: Optional[threading.Event] = None) -> bool:
        """Block until leadership is acquired (or stop_event is set)."""
        while True:
            if self.try_acquire():
                return True
            if stop_event is not None and stop_event.wait(poll_interval):
                return False
            if stop_event is None:
                import time

                time.sleep(poll_interval)

    def release(self) -> None:
        with self._lock:
            if self._fd is not None:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
                self._fd = None

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._fd is not None
