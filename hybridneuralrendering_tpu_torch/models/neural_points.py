"""Neural point cloud (JAX: hybridneuralrendering_tpu/models/neural_points.py).

A fixed-capacity cloud: all five per-point attributes live stacked in one
table [N, table_width] (xyz | embedding | conf | color | dirs | zero pad),
live points marked by `mask`.  The render gathers rows of the table for the
[R, SR, K] neighbour ids, directly or (the pyramid-cached training step)
through a compact table of the unique rows, ranked by the cumsum_rows
kernel (ops/scan.py); under autograd the gather's backward sorts the
cotangent rows by id and reduces them with the segment-sum kernel
(ops/segment_sum.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from hybridneuralrendering_tpu_torch.config import PointsConfig
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.ops.scan import cumsum_rows
from hybridneuralrendering_tpu_torch.ops.segment_sum import segment_sum

ATTR_ORDER = ("xyz", "embedding", "conf", "color", "dirs")


def attr_widths(feature_dim: int) -> Tuple[int, ...]:
    return (3, feature_dim, 1, 3, 3)


def table_width(feature_dim: int) -> int:
    """Stacked row width, zero-padded to a multiple of 64."""
    used = sum(attr_widths(feature_dim))
    return used + (-used) % 64


@dataclasses.dataclass
class NeuralPoints:
    table: torch.Tensor       # [N, table_width(F)] f32
    mask: torch.Tensor        # [N] bool, live point
    num_live: int
    feature_dim: int = 32
    trainable: Tuple[bool, ...] = (False, True, True, True, True)

    def _view(self, name: str) -> torch.Tensor:
        o = 0
        for nm, w in zip(ATTR_ORDER, attr_widths(self.feature_dim)):
            if nm == name:
                return self.table[:, o:o + w]
            o += w
        raise KeyError(name)

    @property
    def xyz(self) -> torch.Tensor:
        return self._view("xyz")

    @property
    def embedding(self) -> torch.Tensor:
        return self._view("embedding")

    @property
    def conf(self) -> torch.Tensor:
        return self._view("conf")

    @property
    def color(self) -> torch.Tensor:
        return self._view("color")

    @property
    def dirs(self) -> torch.Tensor:
        return self._view("dirs")

    @property
    def capacity(self) -> int:
        return self.table.shape[0]


def build_table(feature_dim: int, xyz, embedding, conf, color,
                dirs) -> np.ndarray:
    """Stacked table [n, table_width] f32 from per-attribute host arrays."""
    n = len(xyz)
    parts = [np.asarray(p, np.float32).reshape(n, -1)
             for p in (xyz, embedding, conf, color, dirs)]
    used = sum(p.shape[1] for p in parts)
    pad = np.zeros((n, table_width(feature_dim) - used), np.float32)
    return np.concatenate(parts + [pad], axis=1)


def init_from_arrays(xyz: np.ndarray, cfg: PointsConfig,
                     embedding: Optional[np.ndarray] = None,
                     conf: Optional[np.ndarray] = None,
                     color: Optional[np.ndarray] = None,
                     dirs: Optional[np.ndarray] = None,
                     generator: Union[np.random.Generator,
                                      torch.Generator, None] = None,
                     device="cuda") -> NeuralPoints:
    """Padded NeuralPoints of capacity cfg.num_points from host arrays.

    A missing embedding is drawn as normal * 0.1 from `generator` (a numpy
    or CPU torch generator; numpy seed 0 when None), a missing conf is 1."""
    dev = resolve(device)
    n = len(xyz)
    cap = cfg.num_points
    if n > cap:
        raise ValueError(f"{n} points exceed capacity {cap}")

    def pad(a, width):
        out = np.zeros((cap, width), np.float32)
        if a is not None:
            out[:n] = np.asarray(a, np.float32).reshape(n, width)
        return out

    if embedding is None:
        if isinstance(generator, torch.Generator):
            emb = torch.randn((n, cfg.feature_dim), generator=generator)
            emb = emb.numpy() * 0.1
        else:
            rng = generator if generator is not None \
                else np.random.default_rng(0)
            emb = rng.standard_normal((n, cfg.feature_dim)) * 0.1
        embedding = emb
    conf = conf if conf is not None else np.ones((n, 1))
    table = build_table(cfg.feature_dim, pad(xyz, 3),
                        pad(embedding, cfg.feature_dim), pad(conf, 1),
                        pad(color, 3), pad(dirs, 3))
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return NeuralPoints(
        table=torch.as_tensor(table, device=dev),
        mask=torch.as_tensor(mask, device=dev), num_live=n,
        feature_dim=cfg.feature_dim,
        trainable=(cfg.xyz_grad, cfg.feat_grad, cfg.conf_grad,
                   cfg.color_grad, cfg.dir_grad))


class SampledPoints(NamedTuple):
    """Per-neighbour gathered attributes, [R, SR, K, .]."""

    xyz: torch.Tensor         # [R, SR, K, 3]
    embedding: torch.Tensor   # [R, SR, K, F]
    conf: torch.Tensor        # [R, SR, K]
    color: torch.Tensor       # [R, SR, K, 3]
    dirs: torch.Tensor        # [R, SR, K, 3]


def segment_ends(si: torch.Tensor, n: int) -> torch.Tensor:
    """Inclusive segment ends of sorted ids si [M]: end_pos[p] is the last
    position j with si[j] <= p, -1 where there is none ([n] int32).  The
    JAX package scatters each id's last position and takes a running max;
    one binary search per id gives the same array."""
    ids = torch.arange(n, dtype=si.dtype, device=si.device)
    return torch.searchsorted(si, ids, right=True, out_int32=True) - 1


def dedup_gather(table: torch.Tensor, idx: torch.Tensor,
                 u_cap: int) -> torch.Tensor:
    """table[max(idx, 0)] through a compact table of the unique rows (JAX:
    neural_points._dedup_gather_impl).  One stable sort of the flat ids;
    the unique ids are ranked by the int32 scan of their first-slot flags
    (cumsum_rows); the min(u_cap, m) first unique rows are gathered once
    into a compact table and expanded to the m slots by rank.  When a step
    touches more than that many unique ids, the direct gather table[idx]
    runs instead (JAX picks the branch with lax.cond).  Either way every
    row is a copy, so the result equals table[max(idx, 0)] bit for bit.

    Choosing the branch reads the unique count on the host: one
    synchronisation per call (its cost: PERF.md)."""
    flat = torch.clamp(idx.reshape(-1), min=0).to(torch.int32)
    m = flat.shape[0]
    u_cap = min(int(u_cap), m)
    out_shape = tuple(idx.shape) + (table.shape[-1],)
    if u_cap <= 0:
        return table[flat.long()].reshape(out_shape)
    si, order = torch.sort(flat, stable=True)
    is_new = torch.ones(m, dtype=torch.int32, device=flat.device)
    is_new[1:] = si[1:] != si[:-1]
    uid_sorted = (cumsum_rows(is_new) - 1).long()           # [m] rank
    if int(uid_sorted[-1]) >= u_cap:                        # host sync
        return table[flat.long()].reshape(out_shape)
    # cid[u] = the point id of unique row u (every slot of a segment writes
    # the same id); ranks past the unique count keep id 0, as in JAX
    cid = torch.zeros(u_cap, dtype=torch.long, device=flat.device)
    cid[uid_sorted] = si.long()
    compact = table[cid]                                    # [u_cap, C]
    uid = torch.empty_like(uid_sorted).scatter_(0, order, uid_sorted)
    return compact[uid].reshape(out_shape)


class _GatherRows(torch.autograd.Function):
    """table [N, C] -> table[max(idx, 0)] with a sort-based backward (JAX:
    neural_points._gather_rows, which the caller hands clamped ids, and
    _gather_rows_dedup, whose backward is the same).  With `dedup` > 0 the
    forward runs dedup_gather(table, idx, dedup).

    Backward: one stable sort of the flat ids gives the sorted ids and the
    permutation; the cotangent rows are permuted into id order, the
    inclusive segment ends are built (segment_ends), and the segment-sum
    kernel reduces each id's rows.  No scatter-add: deterministic, and
    absent ids get exact zeros.  A bf16 cotangent is summed in float32 and
    rounded once at the end.

    Negative ids (empty slots) read row 0, and their cotangent rows are
    summed onto row 0 by one column sum: they sort after every real id, so
    the kernel's segments hold only real ids.  In a training step two
    thirds of the neighbour slots are empty, and as one segment they would
    set the kernel's time."""

    @staticmethod
    def forward(ctx, table, idx, dedup):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        if dedup:
            return dedup_gather(table, idx, dedup)
        return table[torch.clamp(idx, min=0)]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n = ctx.n
        with record_function("gather.bwd"):
            flat_i = idx.reshape(-1)
            flat_g = g.reshape(-1, g.shape[-1]).to(torch.float32)
            empty = flat_i < 0
            si, order = torch.sort(
                torch.where(empty, n, flat_i).to(torch.int32), stable=True)
            grad = segment_sum(flat_g[order], segment_ends(si, n), n)
            grad[0] += torch.where(empty[:, None], flat_g, 0.0).sum(dim=0)
        return grad.to(g.dtype), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                dedup: int = 0) -> torch.Tensor:
    """table[idx] for ids >= 0, row 0 for ids < 0; differentiable in the
    table through the segment-sum kernel.  `dedup` > 0 gathers through a
    compact table of at most that many unique rows (dedup_gather)."""
    return _GatherRows.apply(table, idx, int(dedup))


def gather(points: NeuralPoints, sample_pidx: torch.Tensor,
           dedup: int = 0) -> SampledPoints:
    """Rows of the point table for neighbour ids [R, SR, K]; empty slots
    (-1) read row 0 and are masked downstream by pnt_mask.  One row gather
    of the stacked table (gather_rows; through the unique rows when
    `dedup` > 0), then a split.  Frozen attributes are detached after the
    gather, so their lanes of the table gradient are exact zeros."""
    out = gather_rows(points.table, sample_pidx.long(), dedup)
    parts = torch.split(
        out, list(attr_widths(points.feature_dim)) + [
            out.shape[-1] - sum(attr_widths(points.feature_dim))],
        dim=-1)[:5]
    xyz, emb, conf, color, dirs = [
        p if trainable else p.detach()
        for p, trainable in zip(parts, points.trainable)]
    return SampledPoints(xyz=xyz, embedding=emb, conf=conf[..., 0],
                         color=color, dirs=dirs)


def prune(points: NeuralPoints, thresh: float) -> NeuralPoints:
    """Drop the live points whose conf is not above `thresh` (JAX:
    neural_points.prune; reference prune, neural_points.py:350-373).  Pure
    masking: capacity and table unchanged, `num_live` recounted.  Returns a
    new NeuralPoints sharing the input's table."""
    keep = points.mask & (points.conf[:, 0] > thresh)
    return dataclasses.replace(points, mask=keep,
                               num_live=int(keep.sum()))


def grow(points: NeuralPoints, new_xyz: torch.Tensor,
         new_embedding: torch.Tensor, new_conf: torch.Tensor,
         new_color: torch.Tensor, new_dirs: torch.Tensor,
         new_mask: torch.Tensor) -> NeuralPoints:
    """Write the new points of `new_mask` [M] into free capacity slots
    (JAX: neural_points.grow; reference grow_points, neural_points.py:
    376-402): the r-th masked new point goes to the r-th free slot in index
    order, and what does not fit is dropped (JAX's mode="drop").  The new
    points' ranks and the free slots' ranks are int32 row scans
    (cumsum_rows: the kernel on the card).  Returns a new NeuralPoints on
    the points' device; the input is left untouched."""
    cap = points.capacity
    dev = points.table.device
    new_mask = new_mask.to(device=dev, dtype=torch.bool)
    M = new_mask.shape[0]
    if M == 0:
        return dataclasses.replace(points, table=points.table.clone(),
                                   mask=points.mask.clone())
    free = ~points.mask
    order = cumsum_rows(new_mask.to(torch.int32)).long() - 1      # [M]
    free_rank = cumsum_rows(free.to(torch.int32)).long() - 1      # [N]
    # slot_of_rank[r] = index of the r-th free slot, cap past the last
    slot_of_rank = torch.full((cap,), cap, dtype=torch.long, device=dev)
    slot_of_rank[free_rank[free]] = torch.nonzero(free).reshape(-1)
    dest = slot_of_rank[torch.clamp(order, 0, cap - 1)]
    dest = torch.where(new_mask, dest, cap)
    keep = dest < cap
    parts = [torch.as_tensor(p, dtype=torch.float32, device=dev).reshape(M, -1)
             for p in (new_xyz, new_embedding, new_conf, new_color, new_dirs)]
    width = points.table.shape[1]
    used = sum(p.shape[1] for p in parts)
    new_table = torch.cat(parts + [parts[0].new_zeros(M, width - used)],
                          dim=1)
    table = points.table.clone()
    mask = points.mask.clone()
    table[dest[keep]] = new_table[keep]
    mask[dest[keep]] = True
    return dataclasses.replace(points, table=table, mask=mask,
                               num_live=int(mask.sum()))
