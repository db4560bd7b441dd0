"""Inclusive cumsum of rows along axis 0: ranks in the dedup gather and the
voxel-grid build.

`cumsum_rows` is the port of the Pallas TPU kernel
`tools/pallas_scan.py:cumsum_rows`.  On a CUDA tensor it launches the
hand-written kernel `csrc/cumsum_rows.cu`; on a CPU tensor it runs
`cumsum_rows_plain`.  Two types: float32 (the TPU kernel's function) and
int32 (ranks of 0/1 flags, exact for every sum below 2**31, where float32
stops being exact at 2**24).  On int32 the kernel equals the plain version
bit for bit (a 1-D int32 x takes the kernel's one-pass look-back path); on
float32 it sums in another order, within `tolerance`.
"""

from __future__ import annotations

import ctypes
import math

import torch

# shared library name -> its sources under csrc/
KERNEL_LIBS = {"cumsum_rows": ["cumsum_rows.cu"]}
# the kernel's tiles (csrc/cumsum_rows.cu): F == 1 takes THREADS threads
# x VECS vectors of VEC consecutive elements per block (WARPS warps of
# VECS * 32 vectors each), F > 1 GROUPS row groups of ROWS_PER_GROUP rows
# per block
THREADS, VECS, VEC = 256, 8, 4
WARPS = THREADS // 32
GROUPS, ROWS_PER_GROUP = 8, 32
DTYPES = (torch.float32, torch.int32)

_launch = None


def tile_rows(F: int) -> int:
    return THREADS * VECS * VEC if F == 1 else GROUPS * ROWS_PER_GROUP


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """x [M] or [M, F] -> its inclusive cumsum along axis 0, in x's type:
    float32 summed in float64 and rounded once, int32 summed in int64 and
    wrapped to int32 as the kernel wraps."""
    if x.dtype == torch.float32:
        return torch.cumsum(x.to(torch.float64), dim=0).to(torch.float32)
    return torch.cumsum(x.to(torch.int64), dim=0).to(torch.int32)


def tolerance(x: torch.Tensor) -> torch.Tensor:
    """Bound on |kernel - plain| per element for float32 x (float64, x's
    shape).

    Each output is a sum in which every input passes through at most
    `depth` float32 roundings, of at most 2**-24 of a partial sum each.
    Within a tile (`spread`): for F == 1 a vector's prefix (VEC - 1), the
    warp's shuffle scan (log2(32) levels), the running sum over a warp's
    VECS steps (VECS - 1) and over the block's warps (WARPS - 1); for
    F > 1 a thread's run (ROWS_PER_GROUP rows) and the GROUPS group sums.
    Across tiles: one block scan per chunk of THREADS tile sums
    (log2(THREADS) levels and one addition), a carry per chunk, and at
    most three final additions; the plain version rounds once more.  So
    |kernel - plain| <= (depth + 2) * 2**-24 * cumsum(|x|)."""
    M = x.shape[0]
    F = x.shape[1] if x.dim() == 2 else 1
    nb = -(-M // tile_rows(F))
    spread = ((VEC - 1) + 5 + (VECS - 1) + (WARPS - 1) if F == 1
              else ROWS_PER_GROUP + GROUPS)
    depth = spread + int(math.log2(THREADS)) + 4 + -(-nb // THREADS)
    return (depth + 2) * 2.0 ** -24 * torch.cumsum(
        x.abs().to(torch.float64), dim=0)


def _kernel():
    global _launch
    if _launch is None:
        from hybridneuralrendering_tpu_torch.ops.build import load_library
        lib = load_library("cumsum_rows", KERNEL_LIBS["cumsum_rows"])
        fn = lib.cumsum_rows_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of x [M] or [M, F] (float32 or int32) along axis 0,
    in x's type and shape.

    CUDA tensors go to the kernel (counted in `cumsum_rows.launches`; an
    empty x launches nothing), CPU tensors to `cumsum_rows_plain`."""
    if x.dim() not in (1, 2):
        raise ValueError(f"need x [M] or [M, F], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"need float32 or int32 x, got {x.dtype}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return cumsum_rows_plain(x)
        raise ValueError(f"cumsum_rows runs on cpu or cuda, not {x.device}")
    x = x.contiguous()
    M = x.shape[0]
    F = x.shape[1] if x.dim() == 2 else 1
    if M == 0 or F == 0:
        return torch.empty_like(x)
    nb = -(-M // tile_rows(F))
    is_int = x.dtype == torch.int32
    if is_int and F == 1:
        # y, then the look-back's status words and ticket ((nb + 1) x 8
        # bytes, zeroed by the launch) 16-byte aligned after it, in one
        # allocation: at the dedup gather's 602,112 ranks the call's time is
        # its host time
        buf = torch.empty(M + 2 * nb + 8, dtype=torch.int32,
                          device=x.device)
        y = buf[:M]
        scratch = buf.data_ptr() + -(-M // 4) * 16
    else:
        y = torch.empty_like(x)
        buf = torch.empty(nb * F, dtype=x.dtype, device=x.device)
        scratch = buf.data_ptr()
    dev = x.get_device()
    err = _kernel()(x.data_ptr(), y.data_ptr(), scratch, M, F, int(is_int),
                    dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"cumsum_rows kernel launch failed: cudaError "
                           f"{err}")
    cumsum_rows.launches += 1
    return y


cumsum_rows.launches = 0
