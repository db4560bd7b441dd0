"""Process mesh, sharding rules and the ray-sharded training step over
torch.distributed (JAX: hybridneuralrendering_tpu/parallel/mesh.py).

The scaling model is the JAX package's (SURVEY §2.10): rays are
embarrassingly parallel, so a batch's rays shard over the `data` axis of a
mesh of ranks, and the point cloud, the grid and the parameters are
replicated on every rank.  JAX gets the global loss and the gradient psum
from XLA.  Here each rank computes on its own rows, so the ray-sharded step
(make_sharded_train_step) is built to equal the single-process step:

  1. every rank renders its rows of the batch with its rows of the global
     candidate noise and of the global image-feature drop mask;
  2. the per-ray outputs that the blur and the losses read are gathered
     (`_GatherRows`: its backward returns this rank's rows of the incoming
     gradient and communicates nothing, since every rank then computes the
     same loss from the same gathered tensors);
  3. every rank runs the blur and the losses over all R rays
     (train/step.loss_of_render), so the masked means, the miss count and
     the blur's patches are the single-process ones;
  4. the gradients of the leaves read before the gather (the network's
     render leaves and the point table) are summed over the data group; the
     leaves read only after it (the learnable blur's MLP,
     `post_gather_leaves`) keep their gradient, which every rank computed
     alike; both Adams then run on every rank, so the replicated state stays
     identical across ranks.

The collectives are all_reduce, list all_gather, broadcast and barrier,
which NCCL and gloo both run (gloo on CUDA tensors too).  A Mesh made
without a process group describes a layout only: its collectives raise, as
torch.distributed does before init_process_group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, FrozenSet, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hybridneuralrendering_tpu_torch.config import Config, ParallelConfig
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import aggregator as agg
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.train import step as step_mod
from hybridneuralrendering_tpu_torch.train.state import tree_leaves


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid out row-major over `shape`, named as JAX's make_mesh
    names its axes: (data,) or ("replica", data).  `coords` are this
    rank's coordinates, `group` the process group of its data axis (None
    without a process group)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...]
    group: Optional[Any] = None

    @property
    def data_size(self) -> int:
        return self.shape[-1]

    @property
    def data_index(self) -> int:
        return self.coords[-1]


def make_mesh(cfg: ParallelConfig, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh of `world_size` ranks (default: the process group's, or 1
    without one) as `cfg.mesh_shape` lays them out; None puts every rank
    on `data`.  With a process group every rank makes every data group, in
    one order, as dist.new_group requires."""
    grouped = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    shape = tuple(cfg.mesh_shape or (world_size,))
    if len(shape) > 2 or int(np.prod(shape)) != world_size:
        raise ValueError(f"mesh_shape {shape} does not lay out "
                         f"{world_size} ranks on (replica, data)")
    names = (cfg.data_axis,) if len(shape) == 1 else ("replica",
                                                      cfg.data_axis)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    group = None
    if grouped:
        if world_size != dist.get_world_size():
            raise ValueError(f"a mesh of {world_size} ranks in a process "
                             f"group of {dist.get_world_size()}")
        D = shape[-1]
        if D == world_size:
            group = dist.group.WORLD
        else:
            for r in range(world_size // D):
                g = dist.new_group(list(range(r * D, (r + 1) * D)))
                if r == coords[0]:
                    group = g
    return Mesh(shape, names, coords, group)


class Sharding(NamedTuple):
    """A leaf's layout over a mesh: `spec` names the mesh axes its leading
    dimension splits over (JAX's PartitionSpec); () is replicated."""

    mesh: Mesh
    spec: Tuple[str, ...]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def ray_sharded(mesh: Mesh, cfg: ParallelConfig) -> Sharding:
    return Sharding(mesh, (cfg.data_axis,))


# Batch keys whose leading dim is the ray axis R.
RAY_AXIS_KEYS: FrozenSet[str] = frozenset({
    "raydir", "pixel_idx", "gt_image"})


def batch_shardings(batch: Dict, mesh: Mesh,
                    cfg: ParallelConfig) -> Dict[str, Sharding]:
    """Per-key shardings: ray-major tensors split over `data`, the rest
    replicated."""
    return {k: ray_sharded(mesh, cfg) if k in RAY_AXIS_KEYS
            else replicated(mesh) for k in batch}


def data_rows(x, mesh: Mesh):
    """This rank's rows of `x` (a tensor or an array) over the data axis:
    the data_index-th of data_size equal blocks of its leading dim."""
    R, D = x.shape[0], mesh.data_size
    if R % D:
        raise ValueError(f"{R} rows do not divide over the {D} ranks of "
                         f"the data axis")
    n = R // D
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]


def shard_batch(batch: Dict, mesh: Mesh, cfg: ParallelConfig) -> Dict:
    """This rank's part of the global `batch`: its rows of the ray keys,
    every other key whole.  Ranks with the same data coordinate (replicas)
    hold the same rows."""
    sh = batch_shardings(batch, mesh, cfg)
    return {k: data_rows(v, mesh) if sh[k].spec else v
            for k, v in batch.items()}


def map_arrays(fn, tree):
    """fn over the tensors and numpy arrays of dicts, lists, tuples and
    dataclasses (TrainState, NeuralPoints, AdamState), keeping the
    structure and every other leaf."""
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_arrays(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_arrays(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def replicate_tree(tree, mesh: Mesh, device="cuda"):
    """`tree` with each tensor and numpy array on this rank's `device`,
    holding global rank 0's values: a broadcast from rank 0 to every rank
    of the mesh (JAX's device_put onto a replicated sharding).  Other
    leaves (counts, flags) are kept as each rank has them."""
    dev = resolve(device)

    def put(x):
        t = torch.as_tensor(x).to(dev).clone()
        if t.dtype == torch.bool:
            u = t.to(torch.uint8)
            dist.broadcast(u, src=0)
            return u.to(torch.bool)
        dist.broadcast(t, src=0)
        return t

    return map_arrays(put, tree)


class _GatherRows(torch.autograd.Function):
    """All ranks' rows of a ray-major tensor, in data-axis order.  The
    backward returns this rank's rows of the incoming gradient and sends
    nothing: every rank computes the same function of the gathered
    tensor, so the gradient is already the same on every rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        n = x.shape[0]
        ctx.rows = (mesh.data_index * n, (mesh.data_index + 1) * n)
        send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(send) for _ in range(mesh.data_size)]
        dist.all_gather(parts, send, group=mesh.group)
        out = torch.cat(parts)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g[a:b], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherRows.apply(x, mesh)


def loss_keys(cfg: Config) -> Tuple[str, ...]:
    """The render outputs that train/step.loss_of_render reads (the blur,
    models/losses.compute_losses, the hit share), sorted: every rank
    gathers them in one order."""
    keys = {"coarse_raycolor", "ray_mask"}
    for name in cfg.loss.color_loss_items:
        for prefix in ("ray_masked_", "ray_miss_"):
            if name.startswith(prefix):
                name = name[len(prefix):]
        keys.add(name)
    keys.update(cfg.loss.zero_one_loss_items)
    if cfg.loss.sparse_loss_weight > 0:
        keys.update(("weight", "conf_coefficient"))
    return tuple(sorted(keys))


def sharded_loss(mesh: Mesh, params: Dict, points, grid, batch: Dict,
                 cfg: Config, blur_kernels: Optional[torch.Tensor],
                 noise: torch.Tensor, img_feat_staged=None):
    """train/step.loss_fn over a ray shard.  `batch` is the whole batch,
    the same on every rank, and `noise` its [R, z_depth_dim] noise: this
    rank renders its rows (with its rows of the noise and of the drop
    mask), the outputs the loss reads are gathered, and the loss runs over
    all R rays."""
    if "bg_ray" in batch:
        raise ValueError("the plane background (a per-ray bg_ray) is not "
                         "sharded by the ray-sharded step")
    rows = shard_batch(batch, mesh, cfg.parallel)
    drop = None
    if cfg.agg.drop_ratio > 0:
        drop = data_rows(torch.as_tensor(agg.drop_ray_mask(
            cfg.agg, batch["raydir"].shape[0],
            cfg.sampling.dilation_patch_num,
            cfg.sampling.dilation_patch_size), device=noise.device), mesh)
    out = renderer.render(params, points, grid, rows, cfg, train=True,
                          noise=data_rows(noise, mesh),
                          img_feat_staged=img_feat_staged, drop_mask=drop)
    out = {k: gather_rows(out[k], mesh) for k in loss_keys(cfg) if k in out}
    return step_mod.loss_of_render(params, out, batch, cfg, blur_kernels)


def post_gather_leaves(cfg: Config) -> Tuple[Tuple[str, ...], ...]:
    """Paths into the params of the leaves read only after the gather:
    the learnable blur's MLP (train/step.loss_of_render)."""
    return (("aggregator", "blur_kernel"),) if cfg.agg.learnable_blur_kernel \
        else ()


def _all_reduce_flat(tensors, mesh: Mesh) -> None:
    """Each tensor summed over the data group, in place: one all_reduce
    of their flat concatenation (same dtype)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def reduce_grads(g_net: Dict, g_table: Optional[torch.Tensor], mesh: Mesh,
                 keep_paths=()) -> None:
    """Sum the gradients over the data group in place: the network's in
    one all_reduce, the table's in another; the subtrees at `keep_paths`
    keep their own."""
    keep = set()
    for path in keep_paths:
        sub = g_net
        for k in path:
            sub = sub[k]
        keep.update(id(t) for t in tree_leaves(sub))
    _all_reduce_flat([t for t in tree_leaves(g_net) if id(t) not in keep],
                     mesh)
    if g_table is not None:
        dist.all_reduce(g_table, group=mesh.group)


def sharded_loss_and_grads(mesh: Mesh, state, grid, batch: Dict,
                           blur_kernels: Optional[torch.Tensor], cfg: Config,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           img_feat_staged=None):
    """train/step.loss_and_grads of the whole `batch` with the ray-sharded
    loss, then the gradients reduced over the data group.  The noise is
    the whole batch's: `noise` [R, z_depth_dim], or drawn from
    `generator`, which must be seeded alike on every rank."""
    if noise is None and generator is None:
        raise ValueError("the sharded step needs `noise` or a `generator` "
                         "seeded alike on every rank")
    items, g_net, g_table = step_mod.loss_and_grads(
        state, grid, batch, blur_kernels, cfg, generator, noise,
        img_feat_staged, loss=functools.partial(sharded_loss, mesh))
    reduce_grads(g_net, g_table, mesh, post_gather_leaves(cfg))
    return items, g_net, g_table


def make_sharded_train_step(mesh: Mesh, cfg: Config):
    """The ray-sharded train step: fn(state, grid, batch, blur_kernels,
    generator=None, noise=None, img_feat_staged=None) -> (state, items),
    with `batch` the whole batch on every rank and the state replicated;
    the state's tensors are updated in place, as train/step.train_step
    does, and stay identical across ranks."""

    def fn(state, grid, batch, blur_kernels, generator=None, noise=None,
           img_feat_staged=None):
        items, g_net, g_table = sharded_loss_and_grads(
            mesh, state, grid, batch, blur_kernels, cfg, generator, noise,
            img_feat_staged)
        return step_mod.apply_updates(state, g_net, g_table, cfg), items

    return fn
