"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the ``.cu`` files in
``instarevive_tpu_torch/csrc`` into ``build/kernels/`` at the repository root,
named by a hash of its sources, the headers they include from ``csrc`` and
the flags, so a changed source or header rebuilds and an unchanged one loads
from the cache. The sources expose plain ``extern "C"``
launchers; callers bind them with ``ctypes``. Nothing here runs at import
time: a CPU-only process never touches ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel, in the compiler's output
)
# Every library of the port: name -> sources, relative to ``csrc``.
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",),
    "flash_attn_bwd": ("flash_attn_bwd.cu",),
    "norm_kernels": ("norm_kernels.cu",),
    "gn_conv": ("gn_conv.cu",),
    "swin_attention": ("swin_attention.cu",),
    "filter2d": ("filter2d.cu",),
    "tf32_planes": ("tf32_planes.cu",),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def headers(sources: Sequence[str]) -> List[str]:
    """The files of ``csrc`` that ``sources`` include with ``#include "..."``,
    directly or through one another, relative to ``csrc``, sorted."""
    found, todo = set(), list(sources)
    while todo:
        for name in _INCLUDE.findall((CSRC_DIR / todo.pop()).read_bytes()):
            header = name.decode()
            if header not in found and (CSRC_DIR / header).is_file():
                found.add(header)
                todo.append(header)
    return sorted(found - set(sources))


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where the library built from ``sources`` and the headers they include
    lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers(sources)):
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, bool, str]]:
    """Compile the named libraries of ``LIBRARIES`` (all by default) that have
    no build of their current sources, one ``nvcc`` each, all started together.
    Returns name -> (seconds until its compiler ended, whether a build was
    already there, the compiler's output with the ptxas resource lines)."""
    names = list(LIBRARIES if names is None else names)
    start = time.time()
    running, result = {}, {}
    for name in names:
        so = library_path(name, LIBRARIES[name])
        if so.exists():
            result[name] = (0.0, True, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in LIBRARIES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), cmd, tmp, so)
    for name, (proc, cmd, tmp, so) in running.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            for other, *_ in running.values():
                if other.poll() is None:
                    other.kill()
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        os.replace(tmp, so)
        result[name] = (time.time() - start, False, out)
    return result


def load_library(name: str) -> ctypes.CDLL:
    """The named library of ``LIBRARIES``, compiled unless a build of its
    current sources exists, and loaded once per process."""
    if name not in _loaded:
        build_libraries([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name, LIBRARIES[name])))
    return _loaded[name]
