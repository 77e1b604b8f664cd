"""Build and load the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` has a plain C interface. It is compiled
with nvcc for `sm_90a` into a shared library under `ops/build/` (git-ignored)
at first use and loaded with ctypes. The library's file name carries a hash
of the source and of every `csrc/` header it includes (`#include "..."`,
followed into headers), so an edited source or header never loads a stale
build. Nothing here runs at import time: the CPU tests import every module of
the package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel (ptxas register/shared-memory report), for logs;
# kept beside each library as `<library>.log`, so a later process that finds
# the library built reads the report of its build.
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "built from source at first use on the GPU machine"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """`csrc/<name>.cu` and the `csrc/` files it includes, directly or through
    another header, each once, in the order first met."""
    order = []
    pending = [f"{name}.cu"]
    while pending:
        rel = pending.pop(0)
        if rel in order:
            continue
        order.append(rel)
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            text = f.read()
        pending += [inc.decode() for inc in _INCLUDE.findall(text)
                    if os.path.exists(os.path.join(CSRC_DIR, inc.decode()))]
    return order


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _sources(name):
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> None:
    """Compile every named kernel that has no current build, one nvcc per
    source, all started together. Raises RuntimeError with nvcc's output if
    any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in dict.fromkeys(names):
        path = _lib_path(name)
        if os.path.exists(path):
            if name not in BUILD_LOG and os.path.exists(path + ".log"):
                with open(path + ".log") as f:
                    BUILD_LOG[name] = f.read()
            continue
        # Compile to a temporary name and rename into place, so a process
        # that races this one never loads a half-written library.
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode == 0:
            with open(tmp + ".log", "w") as f:
                f.write(out)
            os.replace(tmp + ".log", path + ".log")
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib
