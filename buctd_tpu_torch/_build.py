"""Build and load the port's hand-written CUDA kernels and its host C++.

Every ``csrc/<name>.cu`` has a plain C interface.  It is compiled with ``nvcc``
for ``sm_90a`` into a shared library under ``buctd_tpu_torch/_build/`` (git
ignores it) the first time a kernel is launched, and loaded with ``ctypes``.
The library's file name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded.  ``csrc/<name>.cpp`` (the host box
NMS) builds the same way with the host C++ compiler (``build_host``,
``load_host``).  Nothing here runs at import time: the CPU tests import every
module of the package on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of buctd_tpu_torch "
                       "are built from csrc/ at first use and need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (the name carries a hash of its
    source and of every header under csrc/)."""
    sha = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{sha.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, temp path, final path), or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent reader sees all or nothing


def build(names) -> None:
    """Build the named kernels, one nvcc per source, all started together."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def build_all() -> list:
    """Build every ``csrc/*.cu``; returns the kernel names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    build(names)
    return names


def build_log(name: str) -> str:
    """nvcc's output for a built kernel (``-Xptxas -v``: registers, spills,
    shared memory per kernel instantiation)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib


HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def host_library_path(name: str) -> Path:
    """Where ``csrc/<name>.cpp`` builds to (the name carries a hash of its
    source and of the flags)."""
    sha = hashlib.sha1((CSRC / f"{name}.cpp").read_bytes())
    sha.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{sha.hexdigest()[:12]}.so"


def build_host(name: str) -> Path:
    """Build ``csrc/<name>.cpp`` with the host C++ compiler (``$CXX``, else
    ``c++``/``g++``) unless built; raises with the compiler's output when it
    fails or no compiler is found."""
    out = host_library_path(name)
    with _lock:
        if out.exists():
            return out
        cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
        if not cxx:
            raise RuntimeError(f"no C++ compiler for csrc/{name}.cpp: set CXX or put "
                               "c++/g++ on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on csrc/{name}.cpp (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is None:
        path = build_host(name)
        with _lock:
            lib = _loaded.get(key)
            if lib is None:
                lib = _loaded[key] = ctypes.CDLL(str(path))
    return lib


def hmma_counts(name: str, kind: str = "") -> dict:
    """Tensor-core (HMMA) instructions in the SASS of each kernel of the built
    library of ``csrc/<name>.cu`` (``cuobjdump -sass``), by mangled function
    name; with ``kind``, only those whose mnemonic holds it (``"TF32"``:
    ``HMMA.1684.F32.TF32``)."""
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(library_path(name))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\S*" + re.escape(kind), line):
            counts[fn] += 1
    return counts
