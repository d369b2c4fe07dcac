"""Build the port's CUDA sources at first use: ``nvcc`` -> shared library ->
``ctypes``.

Every ``csrc/<name>.cu`` exposes a plain C interface, so it compiles in
seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The library name carries a hash of the source and of every header it
includes (``#include "..."`` from ``csrc/``, followed recursively), so an
edited kernel or shared header is never served from a stale build. Libraries go to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``). ``build_all`` starts one ``nvcc``
per source at once and waits for all of them; ``load`` builds one on demand.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: name -> {"seconds": float, "ptxas": str, "path": str} of builds this
#: process ran (empty for libraries found already built)
build_log: dict = {}


def sources() -> list:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def dependencies(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header, in first-seen order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha1()
    for path in dependencies(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every listed source (default: all) that has no current
    build, one ``nvcc`` process per source, all started together. Raises
    with the compiler's output if any fails; returns ``build_log``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": text, "path": str(out)}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return build_log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib
