"""ctypes loader + typed wrapper for the native (C++) control-plane
core, built from ``core/cc/`` into ``_build/core/libhvdtpu_core.so``.

Port of ``horovod_tpu/core/native.py`` (``load`` l.91, ``BatchEntry``
l.200, ``NativeCore`` l.223). The C++ sources and the Makefile are byte
copies of the reference's; the core provides the tensor queue, the
rank-0 negotiation coordinator over TCP, the fusion planner, the
response cache (HOROVOD_CACHE_CAPACITY) and the stall inspector.
``BatchEntry`` and ``NativeCore`` are the reference's. The reference's
``tree_*`` helpers, which place a rank in the hierarchical control
tree, are left out with the tree itself (``common/basics.py`` refuses
HOROVOD_CONTROL_TREE_ARITY >= 2).

Declared differences from the reference's loader, each pinned by
tests/test_torch_port_negotiation.py:

- The library is built at first use into ``horovod_tpu_torch/_build/
  core/`` (``make -C core/cc OUT=<abs path>``), never into the source
  tree; the source-hash stamp and the build lock sit beside it. One
  builder at a time (an exclusive file lock), so N ranks and test
  workers starting together do not race; the library is written under
  a temporary name and renamed into place.
- A library whose stamp does not match the sources is never loaded,
  and nothing falls back: a failed build raises RuntimeError with the
  compiler's output, and no toolchain raises naming it. The in-process
  ``PythonCore`` (``ops/controller.py``) serves a world of one only.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

ENTRY_SEP = b"\x1e"
FIELD_SEP = b"\x1f"

CC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "core")
LIB_NAME = "libhvdtpu_core.so"

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def source_hash(cc_dir: str) -> str:
    """Hash of every .cc/.h and the Makefile in ``cc_dir``: a library
    built from other sources must be rebuilt, not loaded (the Python
    side and a stale core would disagree on the batch-entry layout)."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(cc_dir)):
        if name.endswith((".cc", ".h")) or name == "Makefile":
            with open(os.path.join(cc_dir, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()


def _fresh(lib_path: str, digest: str) -> bool:
    try:
        with open(lib_path + ".srchash") as f:
            return f.read().strip() == digest and os.path.exists(lib_path)
    except OSError:
        return False


def build(cc_dir: Optional[str] = None,
          build_dir: Optional[str] = None) -> str:
    """The path of a library built from ``cc_dir``'s current sources
    (default ``CC_DIR``), building it into ``build_dir`` (default
    ``BUILD_DIR``) first when its stamp does not match. Raises
    RuntimeError when there is no toolchain or the build fails (with
    the compiler's output)."""
    cc_dir, build_dir = cc_dir or CC_DIR, build_dir or BUILD_DIR
    lib_path = os.path.join(build_dir, LIB_NAME)
    digest = source_hash(cc_dir)
    if _fresh(lib_path, digest):
        return lib_path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _fresh(lib_path, digest):
                return lib_path      # another process built it meanwhile
            cxx = os.environ.get("CXX", "g++").split()[0]
            missing = [t for t in ("make", cxx) if shutil.which(t) is None]
            if missing:
                raise RuntimeError(
                    f"native core: cannot build {lib_path}: {missing} not "
                    "found (the negotiated controller needs make and a C++ "
                    "compiler)")
            tmp = f"{lib_path}.tmp.{os.getpid()}"
            try:
                r = subprocess.run(
                    ["make", "-C", cc_dir, "-B", f"OUT={tmp}"],
                    capture_output=True, text=True, timeout=300)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(
                    f"native core: build timed out after {e.timeout} s"
                ) from e
            if r.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError(
                    f"native core: build of {cc_dir} failed (make exit "
                    f"{r.returncode}):\n{r.stdout}{r.stderr}")
            os.replace(tmp, lib_path)
            with open(lib_path + ".srchash", "w") as f:
                f.write(digest)
            return lib_path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load(cc_dir: Optional[str] = None,
         build_dir: Optional[str] = None) -> ctypes.CDLL:
    """The core library, built first if needed (see ``build``)."""
    path = build(cc_dir, build_dir)
    with _libs_lock:
        lib = _libs.get(path)
        if lib is None:
            lib = _libs[path] = _bind(ctypes.CDLL(path))
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hvd_core_create.restype = ctypes.c_void_p
    lib.hvd_core_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.hvd_core_destroy.argtypes = [ctypes.c_void_p]
    lib.hvd_core_ok.argtypes = [ctypes.c_void_p]
    lib.hvd_core_ok.restype = ctypes.c_int
    lib.hvd_core_last_error.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
    lib.hvd_core_last_error.restype = ctypes.c_longlong
    lib.hvd_core_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_longlong, ctypes.c_char_p]
    lib.hvd_core_join.argtypes = [ctypes.c_void_p]
    lib.hvd_core_all_joined.argtypes = [ctypes.c_void_p]
    lib.hvd_core_all_joined.restype = ctypes.c_int
    lib.hvd_core_cycles.argtypes = [ctypes.c_void_p]
    lib.hvd_core_cycles.restype = ctypes.c_longlong
    lib.hvd_core_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_double]
    lib.hvd_core_next_batch.restype = ctypes.c_longlong
    lib.hvd_core_shutdown.argtypes = [ctypes.c_void_p]
    lib.hvd_core_set_fusion_threshold.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong]
    lib.hvd_core_set_cycle_time.argtypes = [
        ctypes.c_void_p, ctypes.c_double]
    lib.hvd_core_set_quiescence.argtypes = [
        ctypes.c_void_p, ctypes.c_int]
    lib.hvd_core_control_bytes.argtypes = [ctypes.c_void_p]
    lib.hvd_core_control_bytes.restype = ctypes.c_longlong
    lib.hvd_core_tree_tier.argtypes = [ctypes.c_void_p]
    lib.hvd_core_tree_tier.restype = ctypes.c_int
    return lib


class BatchEntry:
    __slots__ = ("name", "sig", "active_ranks", "error",
                 "negotiate_us", "meta")

    def __init__(self, name: str, sig: str, active_ranks: int,
                 error: str, negotiate_us: int = 0, meta: str = ""):
        self.name = name
        self.sig = sig
        self.active_ranks = active_ranks
        self.error = error
        self.negotiate_us = negotiate_us
        self.meta = meta

    def metas(self) -> List[str]:
        """Per-world-rank request metadata (';'-joined on the wire)."""
        return self.meta.split(";") if self.meta else []

    def __repr__(self):
        return (f"BatchEntry({self.name}, {self.sig}, "
                f"act={self.active_ranks}, err={self.error!r}, "
                f"neg_us={self.negotiate_us}, meta={self.meta!r})")


class NativeCore:
    """One negotiation controller instance (reference: the per-process
    HorovodGlobalState + background thread)."""

    BUF_SIZE = 1 << 20

    def __init__(self, rank: int, size: int, coord_host: str,
                 coord_port: int, fusion_threshold: int,
                 cycle_time_ms: float, stall_warn_s: float,
                 stall_kill_s: float, connect_timeout_s: float = 30.0,
                 cache_capacity: int = 1024, auth_secret: str = "",
                 tree_arity: int = 0, parent_host: str = "",
                 parent_port: int = 0, listen_port: int = 0,
                 agg_linger_us: int = 200):
        lib = load()
        self._lib = lib
        self._h = lib.hvd_core_create(
            rank, size, coord_host.encode(), coord_port,
            fusion_threshold, cycle_time_ms, stall_warn_s,
            stall_kill_s, connect_timeout_s, cache_capacity,
            auth_secret.encode(), tree_arity, parent_host.encode(),
            parent_port, listen_port, agg_linger_us)
        self._buf = ctypes.create_string_buffer(self.BUF_SIZE)
        if not lib.hvd_core_ok(self._h):
            err = self.last_error()
            lib.hvd_core_destroy(self._h)
            self._h = None
            raise RuntimeError(f"native core init failed: {err}")

    def last_error(self) -> str:
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.hvd_core_last_error(self._h, buf, 4096)
        return buf.raw[:n].decode(errors="replace")

    def submit(self, name: str, sig: str, nbytes: int,
               meta: str = "") -> None:
        self._lib.hvd_core_submit(self._h, name.encode(), sig.encode(),
                                  nbytes, meta.encode())

    def join(self) -> None:
        self._lib.hvd_core_join(self._h)

    def all_joined(self) -> int:
        """-1 until all ranks joined, else the last-joining rank."""
        return self._lib.hvd_core_all_joined(self._h)

    def cycles(self) -> int:
        return self._lib.hvd_core_cycles(self._h)

    def next_batch(self, timeout_s: float
                   ) -> Optional[List[BatchEntry]]:
        """None on shutdown; [] on timeout; else one agreed batch."""
        n = self._lib.hvd_core_next_batch(self._h, self._buf,
                                          self.BUF_SIZE, timeout_s)
        if n <= -2:
            # Buffer too small: the core retained the serialized batch
            # (peek-then-pop), so grow and retry — never drop an
            # agreed batch this rank's peers will execute.
            self.BUF_SIZE = -n
            self._buf = ctypes.create_string_buffer(self.BUF_SIZE)
            n = self._lib.hvd_core_next_batch(self._h, self._buf,
                                              self.BUF_SIZE, timeout_s)
        if n == -1:
            return None
        if n < 0:
            raise RuntimeError(
                "native core batch exceeded buffer after regrow")
        if n == 0:
            return []
        raw = self._buf.raw[:n]
        out = []
        for part in raw.split(ENTRY_SEP):
            name, sig, act, neg_us, meta, err = part.split(FIELD_SEP, 5)
            out.append(BatchEntry(name.decode(), sig.decode(),
                                  int(act.decode() or -1),
                                  err.decode(),
                                  int(neg_us.decode() or 0),
                                  meta.decode()))
        return out

    def set_fusion_threshold(self, nbytes: int) -> None:
        self._lib.hvd_core_set_fusion_threshold(self._h, int(nbytes))

    def set_cycle_time(self, ms: float) -> None:
        self._lib.hvd_core_set_cycle_time(self._h, float(ms))

    def set_quiescence(self, cycles: int) -> None:
        """Coordinator-side quiescence batching (see controller.h
        SetQuiescence): hold fused-batch cuts until the ready set is
        stable for N cycles, so submission storms agree as one
        stable-composition batch."""
        self._lib.hvd_core_set_quiescence(self._h, int(cycles))

    def control_bytes(self) -> int:
        """Ready-announcement bytes this rank sent (0 on rank 0)."""
        return self._lib.hvd_core_control_bytes(self._h)

    def tree_tier(self) -> int:
        """This rank's control-tree tier (0 = root/coordinator)."""
        return self._lib.hvd_core_tree_tier(self._h)

    def shutdown(self) -> None:
        if self._h is not None:
            self._lib.hvd_core_shutdown(self._h)

    def destroy(self) -> None:
        if self._h is not None:
            self._lib.hvd_core_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.destroy()
        except Exception:
            pass
