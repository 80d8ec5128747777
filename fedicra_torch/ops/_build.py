"""Build the CUDA sources under ``fedicra_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

into ``fedicra_torch/_build/`` (ignored by git), named by a hash of the
source so an edit rebuilds. The sources compile in parallel, one ``nvcc``
each. A failed build raises; nothing falls back.

Host C++ sources (``csrc/<name>.cpp``, the permutohedral lattice) build
the same way with g++ and the flags of ``fedicra_tpu/native``::

    g++ -O3 -march=native -funroll-loops -fPIC -shared -std=c++17 -pthread \\
        -o _build/lib<name>-<hash>.so csrc/<name>.cpp

on first use (``load_host_library``); ``sources()`` lists the CUDA
sources only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared", "-std=c++17", "-pthread")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str, suffix: str = ".cu") -> Path:
    digest = hashlib.sha256((CSRC / f"{name}{suffix}").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, suffix: str = ".cu") -> str:
    so = _target(name, suffix)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    compiler = [_nvcc(), *NVCC_FLAGS] if suffix == ".cu" else ["g++", *GXX_FLAGS]
    cmd = [*compiler, "-o", str(tmp), str(CSRC / f"{name}{suffix}")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed on {name}{suffix} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)  # atomic: a process building beside this one never loads half a file
    return proc.stdout


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) for each source that was built.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in sources() if not _target(name).exists()]
    # one thread per source, each waiting on its nvcc; leaving the pool
    # waits for every compile, so no nvcc outlives a failure
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        return dict(zip(todo, pool.map(_compile, todo)))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built first if needed."""
    so = _target(name)
    if not so.exists():
        build_all()
    return ctypes.CDLL(str(so))


@functools.cache
def load_host_library(name: str) -> ctypes.CDLL:
    """The compiled library of the host source ``csrc/<name>.cpp``, built
    with g++ first if needed."""
    so = _target(name, ".cpp")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(name, ".cpp")
    return ctypes.CDLL(str(so))
