"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` compiles on its own, with a plain C interface,
into ``<build dir>/<name>-<hash>.so``: the hash covers the source and the
flags, so an edited kernel never loads a stale library.  The build
directory is ``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch`` at the
repository root (``.gitignore`` lists ``build/``).  Nothing compiles at
import time: a library is built at its first use, or ahead of time by
:func:`build_all`, which starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CSRC", "NVCC_FLAGS", "SOURCES", "BUILD_LOG", "build_all",
           "build_dir", "check", "library", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: kernel library name → source file under ``csrc/``
SOURCES = {"store_probe": "store_probe.cu", "feed_fused": "feed_fused.cu",
           "fish_count": "fish_count.cu", "ssd": "ssd.cu"}

#: ``sm_90a`` (Hopper); ``-fmad=false`` keeps every float expression
#: rounding op by op, as the plain PyTorch versions do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library built in this process: nvcc's output (ptxas's report)
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{tag}.so"


def build_all(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns the names it built (cached ones are not)."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        dst = _target(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    failed = []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return list(procs)


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with ``argtypes``
    set from ``signatures`` (function → argument ctypes).  Every entry
    returns the ``cudaGetLastError()`` of its launches as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
