"""Builds the port's hand-written CUDA kernels and loads them with ctypes.

Every ``src/repro_torch/csrc/<name>.cu`` compiles on its own into
``<package>/build/<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --split-compile=0

The sources have a plain C interface (no PyTorch headers), so a build takes
seconds per kernel instantiation; ``--split-compile=0`` lets the device
compiler optimise a source's many instantiations (head_dim x group bound
x type in the decode kernels) on every core at once. The library name carries a hash of its source, of the shared
headers in ``csrc/*.cuh`` (``hopper.cuh``: the TMA, mbarrier and wgmma
helpers) and of the flags, so an edited source or header rebuilds and a
stale library is never loaded. The tensor-core kernels fetch the CUDA
driver API's ``cuTensorMapEncodeTiled`` through the CUDA runtime at run
time, so no library links ``libcuda``. Nothing is built when this module
is imported: ``build_all`` (or the first ``load``) does it,
starting one ``nvcc`` per source at once and waiting for all of them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source, for every source in ``csrc/``."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({cuda_home}); the CUDA kernels cannot be built")


def headers() -> List[Path]:
    """The shared headers (``csrc/*.cuh``) any source may include."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def lib_path(name: str) -> Path:
    """The library of source ``name``, named by a hash of the source, every
    header in ``csrc/`` and the flags: an edit to any of them rebuilds."""
    h = hashlib.sha1(sources()[name].read_bytes())
    for header in headers():
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build every named kernel library that is not built yet, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    names = list(sources()) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        # build under a private name and rename: a concurrent process
        # never loads a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (building it first if needed). Every
    library exports ``error_string(int) -> const char*``."""
    lib = ctypes.CDLL(str(build_all([name])[name]))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, which the launch plans read."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
