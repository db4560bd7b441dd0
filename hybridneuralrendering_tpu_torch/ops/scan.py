"""Inclusive cumsum of rows along axis 0: ranks in the dedup gather and the
voxel-grid build.

`cumsum_rows` is the port of the Pallas TPU kernel
`tools/pallas_scan.py:cumsum_rows`.  On a CUDA tensor it launches the
hand-written kernel `csrc/cumsum_rows.cu`; on a CPU tensor it runs
`cumsum_rows_plain`.  Two types: float32 (the TPU kernel's function) and
int32 (ranks of 0/1 flags, exact for every sum below 2**31, where float32
stops being exact at 2**24).  On int32 the kernel equals the plain version
bit for bit; on float32 it sums in another order, within `tolerance`.
"""

from __future__ import annotations

import ctypes
import math

import torch

# shared library name -> its sources under csrc/
KERNEL_LIBS = {"cumsum_rows": ["cumsum_rows.cu"]}
# the kernel's tiles (csrc/cumsum_rows.cu): F == 1 takes THREADS * ITEMS
# consecutive elements per block, F > 1 GROUPS row groups of ROWS_PER_GROUP
# rows per block
THREADS, ITEMS = 256, 16
GROUPS, ROWS_PER_GROUP = 8, 32
DTYPES = (torch.float32, torch.int32)


def tile_rows(F: int) -> int:
    return THREADS * ITEMS if F == 1 else GROUPS * ROWS_PER_GROUP


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
    `depth` float32 roundings, of at most 2**-24 of a partial sum each:
    within a thread's run (ITEMS elements, or ROWS_PER_GROUP rows), across
    the block (log2(THREADS) shuffle levels, or GROUPS group sums), across
    tiles (the tile sums, one block scan per chunk of THREADS tiles and a
    carry per chunk) and the final additions; the plain version rounds once
    more.  So |kernel - plain| <= (depth + 2) * 2**-24 * cumsum(|x|)."""
    M = x.shape[0]
    F = x.shape[1] if x.dim() == 2 else 1
    nb = -(-M // tile_rows(F))
    spread = (ITEMS + int(math.log2(THREADS)) if F == 1
              else ROWS_PER_GROUP + GROUPS)
    depth = spread + 12 + -(-nb // THREADS)
    return (depth + 2) * 2.0 ** -24 * torch.cumsum(
        x.abs().to(torch.float64), dim=0)


def _kernel():
    from hybridneuralrendering_tpu_torch.ops.build import load_library
    lib = load_library("cumsum_rows", KERNEL_LIBS["cumsum_rows"])
    fn = lib.cumsum_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of x [M] or [M, F] (float32 or int32) along axis 0,
    in x's type and shape.

    CUDA tensors go to the kernel (counted in `cumsum_rows.launches`; an
    empty x launches nothing), CPU tensors to `cumsum_rows_plain`."""
    if x.dim() not in (1, 2):
        raise ValueError(f"need x [M] or [M, F], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"need float32 or int32 x, got {x.dtype}")
    if x.device.type == "cpu":
        return cumsum_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum_rows runs on cpu or cuda, not {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    M = x.shape[0]
    F = x.shape[1] if x.dim() == 2 else 1
    if M == 0 or F == 0:
        return y
    nb = -(-M // tile_rows(F))
    part = torch.empty(nb * F, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), y.data_ptr(), part.data_ptr(), M, F,
                        int(x.dtype == torch.int32), stream)
    if err != 0:
        raise RuntimeError(f"cumsum_rows kernel launch failed: cudaError "
                           f"{err}")
    cumsum_rows.launches += 1
    return y


cumsum_rows.launches = 0
