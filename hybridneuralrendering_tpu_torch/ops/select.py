"""K smallest entries per row: the K-NN's final select.

`k_smallest` is the port of the Pallas TPU kernel
`hybridneuralrendering_tpu/ops/pallas_select.py:k_smallest`.  On a CUDA tensor
it launches the hand-written kernel `csrc/k_smallest.cu`; on a CPU tensor it
runs `k_smallest_plain`, the K argmin-and-mask passes of the JAX package's
`k_smallest_xla`.  The two return bit-identical results: selection does no
arithmetic, and both break ties toward the lowest column.  The kernel gives
rows of up to 64 candidates with k up to 16 (the main path's) a thread each,
in tiles of TILE_ROWS rows, and wider rows or a larger k a warp each.
"""

from __future__ import annotations

import ctypes

import torch

BIG = 1e30
MAX_COLUMNS = 1024   # the warp-per-row path holds at most 32 per lane
TILE_ROWS = 128      # rows of a thread-per-row tile (kTile in the source)
# shared library name -> its sources under csrc/
KERNEL_LIBS = {"k_smallest": ["k_smallest.cu"]}


def k_smallest_plain(d: torch.Tensor, ids: torch.Tensor, k: int):
    """d: [S, C] f32; ids: [S, C] i32 -> (best_d [S, k] ascending, best_i).

    Each pass takes the row minimum, the first column that reaches it, and
    overwrites that entry with BIG."""
    S, C = d.shape
    cd = d.clone()
    col = torch.arange(C, device=d.device)
    out_d = torch.empty((S, k), dtype=torch.float32, device=d.device)
    out_i = torch.empty((S, k), dtype=torch.int32, device=d.device)
    for j in range(k):
        m = cd.min(dim=1, keepdim=True).values
        am = torch.where(cd <= m, col, C).min(dim=1, keepdim=True).values
        out_d[:, j] = m[:, 0]
        out_i[:, j] = ids.gather(1, am)[:, 0]
        cd.scatter_(1, am, BIG)
    return out_d, out_i


def _kernel():
    from hybridneuralrendering_tpu_torch.ops.build import load_library
    lib = load_library("k_smallest", KERNEL_LIBS["k_smallest"])
    fn = lib.k_smallest_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def k_smallest(d: torch.Tensor, ids: torch.Tensor, k: int):
    """K smallest of each row, ascending, with their ids.

    CUDA tensors go to the kernel (counted in `k_smallest.launches`; an
    empty batch launches nothing), CPU tensors to `k_smallest_plain`.  On
    the card d and ids must be contiguous; any 4-byte-aligned view is
    taken as it is."""
    if d.shape != ids.shape or d.dim() != 2:
        raise ValueError(f"d {tuple(d.shape)} and ids {tuple(ids.shape)} "
                         "must be one [S, C] shape")
    if d.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"need float32 d and int32 ids, got {d.dtype}, "
                        f"{ids.dtype}")
    if d.device != ids.device:
        raise ValueError("d and ids lie on different devices")
    if d.device.type == "cpu":
        return k_smallest_plain(d, ids, k)
    if d.device.type != "cuda":
        raise ValueError(f"k_smallest runs on cpu or cuda, not {d.device}")
    S, C = d.shape
    if not 1 <= C <= MAX_COLUMNS or k < 1 or S >= 2 ** 31:
        raise ValueError(f"k_smallest kernel takes 1 <= C <= {MAX_COLUMNS}, "
                         f"k >= 1 and S < 2**31, got S={S}, C={C}, k={k}")
    if not (d.is_contiguous() and ids.is_contiguous()):
        raise ValueError("k_smallest kernel takes contiguous d and ids")
    out_d = torch.empty((S, k), dtype=torch.float32, device=d.device)
    out_i = torch.empty((S, k), dtype=torch.int32, device=d.device)
    if S == 0:
        return out_d, out_i
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(d.data_ptr(), ids.data_ptr(), out_d.data_ptr(),
                        out_i.data_ptr(), S, C, k, stream)
    if err != 0:
        raise RuntimeError(f"k_smallest kernel launch failed: cudaError {err}")
    k_smallest.launches += 1
    return out_d, out_i


k_smallest.launches = 0
