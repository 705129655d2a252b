"""Deterministic-execution-order assertion mode.

The coordinator's one guarantee — every rank executes the identical
response sequence — is what keeps SPMD collective launches from
deadlocking (reference: controller.cc's ordered ResponseList; the
reference itself has no runtime assertion for it, SURVEY.md §5.2
explicitly lists this as something the rebuild should add).

With HOROVOD_ORDER_CHECK=1 every executed collective's name is folded
into a running digest, in execution order, on every rank;
`hvd.check_execution_order()` (a collective itself) allgathers the
digests and raises if any rank's history diverged. The C++-level twin
of this assertion lives in core/cc/stress_tsan.cc, which checks the
agreed order across two in-process controllers under TSAN.
"""

from __future__ import annotations

import hashlib
import threading


class OrderCheck:
    """Thread-safe running digest of executed op names."""

    def __init__(self):
        self._h = hashlib.sha256()
        self._lock = threading.Lock()
        self.count = 0
        # Number of check_execution_order() calls so far — names the
        # verification gather, so it must advance identically on every
        # rank (the API's calling contract), unlike `count`.
        self.checks = 0

    def record(self, name: str) -> None:
        with self._lock:
            self._h.update(name.encode() + b"\0")
            self.count += 1

    def digest(self) -> bytes:
        with self._lock:
            return self._h.copy().digest()
