"""Segment sum of id-sorted rows: the reduction of the gather backward.

`segment_sum` is the port of the Pallas TPU kernel
`tools/pallas_gather.py:banded_segment_sum`.  On a CUDA tensor it launches
the hand-written kernel `csrc/segment_sum.cu`; on a CPU tensor it runs
`segment_sum_plain`, which sums each segment in float64 and rounds once, so
it is the float32-rounded exact sum.  The kernel sums each segment in
float32 in a fixed order, so the two agree to within the error of that sum
(`tolerance`).
"""

from __future__ import annotations

import ctypes

import torch

# shared library name -> its sources under csrc/
KERNEL_LIBS = {"segment_sum": ["segment_sum.cu"]}
# the kernel's order (csrc/segment_sum.cu): a segment is cut into pieces at
# multiples of ROWS rows; a piece is summed in PARTIALS running sums (row
# r into sum r % PARTIALS), and the pieces of a segment that crosses a tile
# edge in FIXUP_WARPS sums (piece j into sum j % FIXUP_WARPS) added as a
# tree
ROWS, PARTIALS, FIXUP_WARPS = 128, 4, 8

_launch = None


def segment_sum_plain(sg: torch.Tensor, end_pos: torch.Tensor,
                      n: int) -> torch.Tensor:
    """sg [M, C] rows sorted by id; end_pos [n] inclusive segment ends
    (-1 where no row precedes) -> [n, C] float32 per-id sums.

    Segment p is rows (end_pos[p-1], end_pos[p]]; rows after end_pos[n-1]
    belong to no id.  Each segment is summed in float64."""
    C = sg.shape[1]
    if n == 0:
        return sg.new_zeros((0, C), dtype=torch.float32)
    lengths = torch.diff(end_pos.long(), prepend=end_pos.new_full((1,), -1))
    used = int(end_pos[-1]) + 1
    out = torch.segment_reduce(sg[:used].to(torch.float64), "sum",
                               lengths=lengths, axis=0)
    return out.to(torch.float32)


def tolerance(sg: torch.Tensor, end_pos: torch.Tensor,
              n: int) -> torch.Tensor:
    """[n, C] bound on |kernel - plain| per element.

    A segment of L rows is cut into P pieces of at most m = min(L, ROWS)
    rows.  Each piece is summed in PARTIALS running sums of at most
    ceil(m / 4) rows and two levels that add them: ceil(m / 4) + 1
    roundings.  When P > 1, each of the FIXUP_WARPS sums of pieces takes at
    most ceil(P / 8) of them, and a tree of three levels adds those:
    ceil(P / 8) + 2 roundings more.  Each rounding is at most 2**-24 of a
    partial sum, the plain version rounds once more, and one more term
    covers the second order.  So |kernel - plain| <= (depth + 2) * 2**-24 *
    sum(|rows|)."""
    ends = end_pos.long()
    starts = torch.cat([ends.new_full((1,), -1), ends[:-1]]) + 1
    lens = (ends + 1 - starts).clamp(min=0)
    pieces = torch.where(lens > 0, ends // ROWS - starts // ROWS + 1, 0)
    depth = (-(-lens.clamp(max=ROWS) // PARTIALS) + 1
             + torch.where(pieces > 1, -(-pieces // FIXUP_WARPS) + 2, 0))
    return (depth[:, None] + 2) * 2.0 ** -24 * segment_sum_plain(
        sg.abs(), end_pos, n)


def _kernel():
    global _launch
    if _launch is None:
        from hybridneuralrendering_tpu_torch.ops.build import load_library
        lib = load_library("segment_sum", KERNEL_LIBS["segment_sum"])
        fn = lib.segment_sum_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def segment_sum(sg: torch.Tensor, end_pos: torch.Tensor,
                n: int) -> torch.Tensor:
    """Per-id sums of id-sorted rows: rows (end_pos[p-1], end_pos[p]] of
    sg [M, C] float32 sum into row p of the [n, C] float32 result.

    CUDA tensors go to the kernel (counted in `segment_sum.launches`), CPU
    tensors to `segment_sum_plain`."""
    if sg.dim() != 2 or end_pos.dim() != 1 or end_pos.shape[0] != n:
        raise ValueError(f"need sg [M, C] and end_pos [{n}], got "
                         f"{tuple(sg.shape)} and {tuple(end_pos.shape)}")
    if sg.dtype != torch.float32 or end_pos.dtype != torch.int32:
        raise TypeError(f"need float32 sg and int32 end_pos, got {sg.dtype},"
                        f" {end_pos.dtype}")
    if sg.device != end_pos.device:
        raise ValueError("sg and end_pos lie on different devices")
    if not sg.is_cuda:
        if sg.device.type == "cpu":
            return segment_sum_plain(sg, end_pos, n)
        raise ValueError(f"segment_sum runs on cpu or cuda, not {sg.device}")
    M, C = sg.shape
    if C < 1:
        raise ValueError("segment_sum needs at least one column")
    if n * C > 2 ** 32:
        raise ValueError(f"segment_sum writes at most 2**32 elements, not "
                         f"{n} x {C}")
    sg = sg.contiguous()
    end_pos = end_pos.contiguous()
    out = torch.empty((n, C), dtype=torch.float32, device=sg.device)
    # per row tile: the pieces of segments that cross its edges, and an id
    scratch = torch.empty(-(-M // ROWS) * (2 * C + 1), dtype=torch.float32,
                          device=sg.device)
    dev = sg.get_device()
    err = _kernel()(sg.data_ptr(), end_pos.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), M, C, n, dev,
                    torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError "
                           f"{err}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
