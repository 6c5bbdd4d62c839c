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
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CSRC", "NVCC_FLAGS", "SOURCES", "BUILD_LOG", "build_all",
           "build_dir", "check", "kernel_name", "library", "ptxas_report",
           "sass_counts", "stream_ptr"]

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


def _cuda_tool(tool: str) -> Optional[str]:
    """Path of the CUDA toolkit's ``tool`` (``$CUDA_HOME/bin``, ``PATH``,
    ``/usr/local/cuda/bin``), or None."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / tool)] if home else []
    cands += [shutil.which(tool) or "", f"/usr/local/cuda/bin/{tool}"]
    return next((c for c in cands if c and Path(c).is_file()), None)


def _nvcc() -> str:
    nvcc = _cuda_tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return nvcc


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


def kernel_name(symbol: str) -> str:
    """A kernel's short name from its mangled symbol: ``ssd_state_kernel<8>``
    for ``_ZN<ns>16ssd_state_kernelILi8EEEv..``."""
    i = 3 if symbol.startswith("_ZN") else 2
    name = symbol
    while (m := re.match(r"\d+", symbol[i:])) is not None:
        n, i = int(m.group()), i + m.end()
        name, i = symbol[i:i + n], i + n
    t = re.match(r"ILi(\d+)E", symbol[i:])
    return name + (f"<{t.group(1)}>" if t else "")


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of library ``name`` built in this process (short name, as
    :func:`kernel_name`): its registers and spilled bytes, from ptxas's
    ``-v`` report."""
    report: Dict[str, Dict[str, int]] = {}
    cur = None
    for ln in BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = report.setdefault(kernel_name(m.group(1)), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return report


def sass_counts(name: str, opcodes: Iterable[str]
                ) -> Optional[Dict[str, Dict[str, int]]]:
    """Per kernel of the built library ``name`` (short name), how many SASS
    instructions start with each of ``opcodes`` (``cuobjdump -sass``);
    None where the toolkit has no ``cuobjdump`` or it fails."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    try:
        out = subprocess.run([tool, "-sass", str(_target(name))],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    opcodes = tuple(opcodes)
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            fn = counts.setdefault(
                kernel_name(ln.split("Function :", 1)[1].strip()),
                dict.fromkeys(opcodes, 0))
            continue
        # "/*0a30*/  @!P0 HMMA.1688.F32.TF32 R8, R12, R4, R8 ;  /* 0x... */"
        words = ln.split("*/", 1)[1].split() if "*/" in ln else []
        if words and words[0].startswith("@"):  # predicated
            words = words[1:]
        if fn is None or not words:
            continue
        for o in opcodes:
            if words[0].startswith(o):
                fn[o] += 1
    return counts


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
