"""One optax-exact Adam step over the point table, in place.

`adam_table` is the port of the Pallas TPU kernel
`tools/pallas_adam.py:adam_table_update`.  On a CUDA tensor it launches the
hand-written kernel `csrc/adam_table.cu`; on a CPU tensor it runs
`adam_table_plain`, the same arithmetic as separate PyTorch operations.
On the card the two agree bit for bit: the kernel rounds every operation on
its own, and the plain version divides by device tensors (a division by a
Python number would become a multiplication by its reciprocal on the card).

`adam_scalars` gives the eight per-step scalars as optax computes them:
bias correction at t = count + 1 and the learning rate at the schedule's own
(pre-increment) count, in float32.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

# shared library name -> its sources under csrc/
KERNEL_LIBS = {"adam_table": ["adam_table.cu"]}


class AdamScalars(NamedTuple):
    """Float32 values, held as Python floats."""

    b1: float
    b2: float
    c1: float       # 1 - b1
    c2: float       # 1 - b2
    bc1: float      # 1 - b1 ** t
    bc2: float      # 1 - b2 ** t
    neg_lr: float   # -lr(schedule count)
    eps: float


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def adam_scalars(count: int, sched_count: int,
                 schedule: Callable[[int], torch.Tensor], b1: float,
                 b2: float, eps: float = 1e-8) -> AdamScalars:
    """The scalars of one step after `count` earlier steps (optax
    scale_by_adam + scale_by_schedule; `schedule(step)` returns a float32
    tensor)."""
    t = _f32(count + 1)
    return AdamScalars(
        b1=float(_f32(b1)), b2=float(_f32(b2)),
        c1=float(_f32(1.0 - b1)), c2=float(_f32(1.0 - b2)),
        bc1=float(1.0 - _f32(b1) ** t), bc2=float(1.0 - _f32(b2) ** t),
        neg_lr=float(-_f32(schedule(sched_count))), eps=float(_f32(eps)))


def adam_table_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, s: AdamScalars) -> None:
    """p, mu, nu updated in place, one rounded operation at a time:
    mu' = b1*mu + c1*g; nu' = b2*nu + c2*(g*g);
    p' = p + neg_lr * ((mu'/bc1) / (sqrt(nu'/bc2) + eps))."""
    bc1 = torch.tensor(s.bc1, dtype=torch.float32, device=p.device)
    bc2 = torch.tensor(s.bc2, dtype=torch.float32, device=p.device)
    m = torch.add(torch.mul(mu, s.b1), torch.mul(g, s.c1))
    v = torch.add(torch.mul(nu, s.b2), torch.mul(torch.mul(g, g), s.c2))
    den = torch.add(torch.sqrt(torch.div(v, bc2)), s.eps)
    upd = torch.div(torch.div(m, bc1), den)
    mu.copy_(m)
    nu.copy_(v)
    p.add_(torch.mul(upd, s.neg_lr))


def _kernel():
    from hybridneuralrendering_tpu_torch.ops.build import load_library
    lib = load_library("adam_table", KERNEL_LIBS["adam_table"])
    fn = lib.adam_table_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
        ctypes.c_float] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adam_table(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, s: AdamScalars) -> None:
    """One Adam step: p, mu, nu (float32, one shape, contiguous) are
    updated in place from the gradient g.

    CUDA tensors go to the kernel (counted in `adam_table.launches`), CPU
    tensors to `adam_table_plain`."""
    ts = (p, g, mu, nu)
    if any(x.shape != p.shape for x in ts):
        raise ValueError(f"p, g, mu, nu shapes differ: "
                         f"{[tuple(x.shape) for x in ts]}")
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError(f"adam_table needs float32, got "
                        f"{[x.dtype for x in ts]}")
    if any(x.device != p.device for x in ts):
        raise ValueError("p, g, mu, nu lie on different devices")
    if p.device.type == "cpu":
        adam_table_plain(p, g, mu, nu, s)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_table runs on cpu or cuda, not {p.device}")
    if not all(x.is_contiguous() for x in (p, mu, nu)):
        raise ValueError("adam_table updates p, mu and nu in place: they "
                         "must be contiguous")
    g = g.contiguous()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                        nu.data_ptr(), p.numel(), *s, stream)
    if err != 0:
        raise RuntimeError(f"adam_table kernel launch failed: cudaError "
                           f"{err}")
    adam_table.launches += 1


adam_table.launches = 0
