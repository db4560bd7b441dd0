"""ctypes binding of the native batch sampler (JAX:
hybridneuralrendering_tpu/data/native_sampler.py).

`csrc/sampler.cpp`, a copy of the repo's `native/sampler.cpp`, does a
training step's host work off the GIL: dilated pixel sampling, the ground
truth gather and the ray directions, in one call (`assemble_batch`) or on a
pool of worker threads (`PrefetchPipeline`).  It is built at first use with
the host C++ compiler into `build/torch_native/` (ops/build.py).  Where it
cannot be built, `load` raises with the compiler's message: nothing here
falls back to numpy sampling, where the JAX binding returns None.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Tuple

import numpy as np

SOURCES = ["sampler.cpp"]


def load() -> ctypes.CDLL:
    """The sampler library, built on first use; raises if it cannot be."""
    from hybridneuralrendering_tpu_torch.ops.build import load_host_library
    lib = load_host_library("sampler", SOURCES)
    if not getattr(lib, "_typed", False):
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.assemble_batch.restype = None
        lib.assemble_batch.argtypes = ([f32p] + [ctypes.c_int] * 7
                                       + [f32p, f32p, ctypes.c_uint64,
                                          f32p, f32p, f32p])
        lib.pipeline_create.restype = ctypes.c_void_p
        lib.pipeline_create.argtypes = [ctypes.c_int]
        lib.pipeline_submit.restype = ctypes.c_uint64
        lib.pipeline_submit.argtypes = ([ctypes.c_void_p, f32p]
                                        + [ctypes.c_int] * 7
                                        + [f32p, f32p, ctypes.c_uint64])
        lib.pipeline_pop.restype = ctypes.c_uint64
        lib.pipeline_pop.argtypes = [ctypes.c_void_p, f32p, f32p, f32p]
        lib.pipeline_destroy.restype = None
        lib.pipeline_destroy.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _inputs(image, intrinsic, camrot):
    """float32 C-contiguous copies (where needed) of the arrays the library
    reads, after checking the shapes it assumes."""
    image = np.ascontiguousarray(image, np.float32)
    intr = np.ascontiguousarray(intrinsic, np.float32)
    rot = np.ascontiguousarray(camrot, np.float32)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"image must be [H, W, 3], got {image.shape}")
    if intr.shape != (3, 3) or rot.shape != (3, 3):
        raise ValueError(f"intrinsic and camrot must be [3, 3], got "
                         f"{intr.shape} and {rot.shape}")
    return image, intr, rot


def _outputs(n: int):
    return (np.empty((n, 2), np.float32), np.empty((n, 3), np.float32),
            np.empty((n, 3), np.float32))


def assemble_batch(image: np.ndarray, margin: int, patch_num: int,
                   patch_size: int, dil_min: int, dil_max: int,
                   intrinsic: np.ndarray, camrot: np.ndarray, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch: image [H, W, 3] float32, intrinsic [3, 3], camrot [3, 3]
    (camera to world).  Returns (pixel xy [S, S, 2], ground truth rgb
    [S*S, 3], unit ray directions [S*S, 3]), S = patch_num * patch_size."""
    lib = load()
    image, intr, rot = _inputs(image, intrinsic, camrot)
    H, W, _ = image.shape
    side = patch_num * patch_size
    xy, rgb, dirs = _outputs(side * side)
    lib.assemble_batch(_fp(image), H, W, margin, patch_num, patch_size,
                       dil_min, dil_max, _fp(intr), _fp(rot),
                       ctypes.c_uint64(seed), _fp(xy), _fp(rgb), _fp(dirs))
    return xy.reshape(side, side, 2), rgb, dirs


class PrefetchPipeline:
    """Batches assembled on `num_workers` threads.  `submit` queues one and
    returns its ticket; `pop` blocks for a finished one and returns
    (ticket, xy [S*S, 2], rgb, dirs); batches finish in any order when
    several are queued.  The inputs of a submitted batch are held here
    until it is popped.  `close` (or leaving a `with` block, or the
    object's collection) stops the workers."""

    def __init__(self, num_workers: int = 2):
        self._lib = load()
        self._handle = self._lib.pipeline_create(num_workers)
        self._destroy = weakref.finalize(self, self._lib.pipeline_destroy,
                                         self._handle)
        self._held: Dict[int, tuple] = {}
        self._side: Dict[int, int] = {}

    def submit(self, image: np.ndarray, margin: int, patch_num: int,
               patch_size: int, dil_min: int, dil_max: int,
               intrinsic: np.ndarray, camrot: np.ndarray, seed: int) -> int:
        if not self._handle:
            raise RuntimeError("the pipeline is closed")
        image, intr, rot = _inputs(image, intrinsic, camrot)
        H, W, _ = image.shape
        ticket = self._lib.pipeline_submit(
            self._handle, _fp(image), H, W, margin, patch_num, patch_size,
            dil_min, dil_max, _fp(intr), _fp(rot), ctypes.c_uint64(seed))
        self._held[ticket] = (image, intr, rot)
        self._side[ticket] = patch_num * patch_size
        return ticket

    def pop(self) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        if not self._held:
            raise RuntimeError("pop without a submitted batch")
        # every queued batch has one size in practice; the largest bounds
        # the copy whichever of them finishes first
        n = max(self._side.values()) ** 2
        xy, rgb, dirs = _outputs(n)
        ticket = self._lib.pipeline_pop(self._handle, _fp(xy), _fp(rgb),
                                        _fp(dirs))
        self._held.pop(ticket)
        m = self._side.pop(ticket) ** 2
        return ticket, xy[:m], rgb[:m], dirs[:m]

    def close(self) -> None:
        """Stop the workers; queued batches are dropped."""
        if self._handle:
            self._destroy()
            self._handle = None
            self._held.clear()
            self._side.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
