"""Builds and loads the port's hand-written CUDA C++ kernels.

Every kernel library is one source under ``horovod_tpu_torch/csrc/``
with a plain C interface: nvcc compiles it for ``sm_90a`` into a shared
library under ``horovod_tpu_torch/_build/`` at first use, and ctypes
loads it with the argument types of its entry points declared here.
``build()`` compiles every library whose build is missing, one nvcc per
source, all started together, so a first call pays for the slowest
source and not for their sum.

The kernel modules (``ops/flash_attention.py``, ``ops/adasum_kernels.py``)
reach their libraries through ``load_library``; nothing here runs when
the package is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# flash attention: causal, scale, stream
_FLASH_TAIL = [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# Library (= source file stem) -> its C entry points' argument types.
LIBRARIES = {
    "flash_attention_fwd": {
        "hvd_flash_attention_fwd": [_PTR] * 5 + [_INT] * 5 + [_LL] * 9
        + _FLASH_TAIL,
        # D -> the 16-bit kernel's dynamic shared memory in bytes
        "hvd_flash_attention_fwd_smem_bytes": [_INT]},
    "flash_attention_bwd": {
        "hvd_flash_attention_bwd_dkv": [_PTR] * 8 + [_INT] * 5 + [_LL] * 12
        + _FLASH_TAIL,
        "hvd_flash_attention_bwd_dq": [_PTR] * 7 + [_INT] * 5 + [_LL] * 12
        + _FLASH_TAIL,
        # D -> the 16-bit kernels' dynamic shared memory in bytes
        "hvd_flash_attention_bwd_dkv_smem_bytes": [_INT],
        "hvd_flash_attention_bwd_dq_smem_bytes": [_INT]},
    "adasum_pair_combine": {
        # a, b, scratch, stats, dtype, n, stream
        "hvd_adasum_partials": [_PTR] * 4 + [_INT, _LL, _PTR],
        # a, b, stats, out, dtype, n, stream
        "hvd_adasum_scaled_add": [_PTR] * 4 + [_INT, _LL, _PTR],
        # n, dtype -> the partials stage's grid size
        "hvd_adasum_partials_blocks": [_LL, _INT]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
# Library -> the compiler's output of its last verbose build.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "horovod_tpu_torch: nvcc not found (PATH, CUDA_HOME or "
            "/usr/local/cuda/bin); the CUDA kernels cannot be built")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the build of library ``name`` goes: the file name carries
    the hash of its source, the shared headers and the flags, so an
    edited source is rebuilt."""
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (source_path(name),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))):
        with open(path, "rb") as f:
            tag.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{tag.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> Dict[str, str]:
    """Compile every library whose current build is missing, one nvcc
    per source, all started together; concurrent builds serialise on
    a lock file. Returns each library's path."""
    paths = {name: library_path(name) for name in LIBRARIES}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = []
        for name, path in paths.items():
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            jobs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, path, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}{err}")
                continue
            if verbose:
                build_logs[name] = out + err
                print(f"nvcc {name}:\n{out}{err}", flush=True)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("horovod_tpu_torch: nvcc failed for "
                               + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name`` once."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build()[name])
            for fn_name, argtypes in LIBRARIES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
    return _libs[name]


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_resources(log: str) -> List[dict]:
    """Each kernel's registers, static shared memory and spill bytes
    from a ``-Xptxas=-v`` build log, with the performance notes and
    warnings ptxas printed naming it; names are demangled where c++filt
    exists."""
    kernels: List[dict] = []
    notes = [line.strip() for line in log.splitlines()
             if "Performance Loss" in line or "warning" in line.lower()]
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            kernels.append({"kernel": m.group(1), "registers": None,
                            "smem_bytes": 0, "spill_stores": 0,
                            "spill_loads": 0,
                            "notes": [n for n in notes
                                      if f"'{m.group(1)}'" in n]})
            continue
        if not kernels:
            continue
        cur = kernels[-1]
        m = _PTXAS_SPILLS.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            m = _PTXAS_SMEM.search(line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    filt = shutil.which("c++filt")
    if filt and kernels:
        names = subprocess.run([filt], input="\n".join(
            k["kernel"] for k in kernels), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(kernels):
            for k, name in zip(kernels, names):
                k["kernel"] = name
    return kernels
