"""Build a CUDA source of the port into a shared library and load it.

Each library is compiled by `nvcc` into a C-ABI `.so` (no PyTorch headers, so
a build takes seconds) and loaded with `ctypes`.  It is built at first use,
from the package's own sources, into `build/torch_kernels/` at the root of the
checkout; the file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.  The compiler writes to a
temporary name and `os.replace` publishes it, so concurrent builders never
wait on a lock: the last one to finish wins with an identical file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300

_LOADED: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per library name, for the smoke's build report
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of the port need "
                       "the CUDA toolkit")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so,
    unless that file exists, and load it once per process."""
    if name in _LOADED:
        return _LOADED[name]
    paths = [CSRC_DIR / s for s in sources]
    out = BUILD_DIR / f"lib{name}-{_digest(paths)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name} ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    return lib
