"""Build a C++ or CUDA source of the port into a shared library and load it.

Each library is a C-ABI `.so` (no PyTorch headers, so a build takes
seconds) loaded with `ctypes`, built at first use from the package's own
sources under `csrc/`:
  - CUDA kernels by `nvcc` into `build/torch_kernels/` (`load_library`);
  - host code (the native batch sampler) by the host C++ compiler into
    `build/torch_native/` (`load_host_library`).
The file name carries a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses the library.  The compiler writes to a
temporary name and `os.replace` publishes it, so concurrent builders never
wait on a lock: the last one to finish wins with an identical file.  A
missing compiler or a failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NATIVE_BUILD_DIR = PKG_DIR.parent / "build" / "torch_native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# native/Makefile's flags (its -Wall only adds warnings)
HOST_CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
                  "-shared")
BUILD_TIMEOUT_S = 300

_LOADED: Dict[str, ctypes.CDLL] = {}
# seconds spent in the compiler per library name, for the smoke's report
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


def cxx_path() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the "
                       "native batch sampler is built from source")


def _digest(sources: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _load(name: str, sources: Sequence[str], compiler: Callable[[], str],
          flags: Sequence[str], build_dir: Path) -> ctypes.CDLL:
    if name in _LOADED:
        return _LOADED[name]
    paths = [CSRC_DIR / s for s in sources]
    out = build_dir / f"lib{name}-{_digest(paths, flags)}.so"
    if not out.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        tool = compiler()
        cmd = [tool, *flags, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{os.path.basename(tool)} failed for {name} "
                f"({res.returncode}):\n{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    return lib


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile CUDA `sources` (file names under csrc/) with nvcc into
    build/torch_kernels/lib<name>-<hash>.so, unless that file exists, and
    load it once per process."""
    return _load(name, sources, nvcc_path, NVCC_FLAGS, BUILD_DIR)


def load_host_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile C++ `sources` (file names under csrc/) with the host
    compiler into build/torch_native/lib<name>-<hash>.so, unless that file
    exists, and load it once per process."""
    return _load(name, sources, cxx_path, HOST_CXX_FLAGS, NATIVE_BUILD_DIR)
