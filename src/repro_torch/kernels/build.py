"""Build the CUDA kernels from the repository's sources at first use.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface (loaded by ``ctypes``), under
``build/repro_torch_kernels/<name>-<hash>/`` at the repository root, keyed
by a hash of the source, every header in ``csrc/`` (``*.cuh``, which the
sources include) and the flags: an unchanged source is built once per
checkout, and an edited header rebuilds every source.  All sources start
compiling together, and each runs its optimization and ``ptxas`` passes
in parallel (``--split-compile=0``: a thread per core), so that the
longest, ``paged_attention.cu`` with its many instances, no longer sets
the build's wall time alone.  Nothing here runs when the module is
imported; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")
SOURCES = ("paged_attention", "ssd_scan", "flash_attention",
           "flash_attention_bwd", "decode_attention", "chunk_attention",
           "grouped_matmul")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # per source: nvcc's output (ptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_ROOT / f"{name}-{digest[:16]}" / f"lib{name}.so"


def build(names: List[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` per source, all started together.  Returns name -> library."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    procs = {}
    for name, target in todo.items():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)            # atomic: a reader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
