"""One training step (JAX: hybridneuralrendering_tpu/train/step.py,
`train_step`).

render (train mode: jittered candidates, image-feature drop) -> blur-bank
degradation of the predicted colours -> masked losses with the frame
weight -> backward -> two Adams: the point table through the Adam kernel
(ops/adam.py) at `plr`, the network parameters at `lr` through
torch._foreach_* operations that repeat optax's arithmetic.  Without
`img_feat_staged` the pyramid CNN runs inside the step (the uncached,
CNN-burst step); with it the step reads cached stage maps
(train/pyramid_cache.py), the CNN's gradient is zero, and both Adams still
run over every leaf, as optax does: after an uncached step the CNN moves
on a cached step by its first moment alone.

The step updates the state's tensors in place and returns the state.
Float32 convolutions run without TF32 (device.no_tf32), as in serving.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.device import HOST_KEYS, no_tf32
from hybridneuralrendering_tpu_torch.models import blur as blur_mod
from hybridneuralrendering_tpu_torch.models import losses as losses_mod
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.ops.adam import adam_scalars, adam_table
from hybridneuralrendering_tpu_torch.ops.voxel_grid import PointGrid
from hybridneuralrendering_tpu_torch.train.state import (
    TrainState, lr_schedule, tree_leaves, tree_map)

def device_batch(batch: Dict) -> Dict:
    """The batch without its host-only keys (frame and view ids)."""
    return {k: v for k, v in batch.items() if k not in HOST_KEYS}


def forward_with_blur(params: Dict, points: npts.NeuralPoints,
                      grid: PointGrid, batch: Dict, cfg: Config,
                      blur_kernels: Optional[torch.Tensor], train: bool,
                      noise: Optional[torch.Tensor] = None,
                      img_feat_staged=None) -> Dict:
    """Render, then (in training) degrade the predicted colours by the
    best bank kernel per patch."""
    out = renderer.render(params, points, grid, batch, cfg, train=train,
                          noise=noise, img_feat_staged=img_feat_staged)
    if train:
        if cfg.agg.learnable_blur_kernel:
            raise NotImplementedError("the learnable blur kernel is not "
                                      "ported yet")
        if cfg.blur.add_blur_sim and blur_kernels is not None:
            with record_function("train.blur"):
                out["coarse_raycolor"] = blur_mod.blur_bank_update(
                    out["coarse_raycolor"], batch["gt_image"], blur_kernels,
                    cfg.sampling.dilation_patch_num,
                    cfg.sampling.dilation_patch_size)
    return out


def loss_fn(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
            batch: Dict, cfg: Config, blur_kernels: Optional[torch.Tensor],
            noise: Optional[torch.Tensor] = None, img_feat_staged=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = forward_with_blur(params, points, grid, batch, cfg, blur_kernels,
                            train=True, noise=noise,
                            img_feat_staged=img_feat_staged)
    fw = batch.get("frame_weight") if cfg.loss.use_frame_weight else None
    total, items = losses_mod.compute_losses(out, batch["gt_image"],
                                             cfg.loss, fw)
    items["ray_hit_frac"] = torch.mean(out["ray_mask"].to(torch.float32))
    return total, items


def _noise(batch: Dict, cfg: Config, generator, noise):
    if noise is not None:
        return noise
    raydir = batch["raydir"]
    return torch.rand((raydir.shape[0], cfg.querier.z_depth_dim),
                      generator=generator, device=raydir.device)


def loss_and_grads(state: TrainState, grid: PointGrid, batch: Dict,
                   blur_kernels: Optional[torch.Tensor], cfg: Config,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   img_feat_staged=None):
    """The training loss of `state` on `batch` and its gradients.

    Returns (items, grads of the network parameters (the params' nesting),
    grad of the point table or None when no attribute trains).  `noise`
    [R, z_depth_dim] in [0, 1) jitters the candidates; when None it is
    drawn from `generator`.  `img_feat_staged` = (images_nearest,
    (s1, s2, s3)) makes it a cached step."""
    batch = device_batch(batch)
    noise = _noise(batch, cfg, generator, noise)
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      state.params)
    points = state.points
    if state.opt_pts is not None:
        points = dataclasses.replace(
            points, table=points.table.detach().requires_grad_(True))
    with no_tf32():
        with record_function("train.forward"):
            total, items = loss_fn(params, points, grid, batch, cfg,
                                   blur_kernels, noise, img_feat_staged)
        with record_function("train.backward"):
            total.backward()
    g_net = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), params)
    g_table = None
    if state.opt_pts is not None:
        g_table = points.table.grad if points.table.grad is not None \
            else torch.zeros_like(points.table)
    return {k: v.detach() for k, v in items.items()}, g_net, g_table


@torch.no_grad()
def _adam_net(state: TrainState, g_net: Dict, cfg: Config) -> None:
    """optax.adam over the network leaves, in place: the arithmetic of
    ops/adam.adam_table_plain as torch._foreach_* operations."""
    o = cfg.optim
    opt = state.opt_net
    s = adam_scalars(opt.count, opt.count, lr_schedule(o.lr, o), o.beta1,
                     o.beta2)
    p, g = tree_leaves(state.params), tree_leaves(g_net)
    mu, nu = tree_leaves(opt.mu), tree_leaves(opt.nu)
    torch._foreach_mul_(mu, s.b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, s.c1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, s.c2)
    torch._foreach_mul_(nu, s.b2)
    torch._foreach_add_(nu, g2)
    den = torch._foreach_div(nu, s.bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, s.eps)
    upd = torch._foreach_div(mu, s.bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, s.neg_lr)
    torch._foreach_add_(p, upd)
    opt.count += 1


@torch.no_grad()
def _adam_table(state: TrainState, g_table: torch.Tensor,
                cfg: Config) -> None:
    o = cfg.optim
    opt = state.opt_pts
    s = adam_scalars(opt.count, opt.count, lr_schedule(o.plr, o), o.beta1,
                     o.beta2)
    adam_table(state.points.table, g_table, opt.mu, opt.nu, s)
    opt.count += 1


def apply_updates(state: TrainState, g_net: Dict,
                  g_table: Optional[torch.Tensor], cfg: Config) -> TrainState:
    """Both Adam steps, in place; the step count advances by one."""
    with record_function("adam.table"):
        if g_table is not None:
            _adam_table(state, g_table, cfg)
    with record_function("adam.net"):
        _adam_net(state, g_net, cfg)
    state.step += 1
    return state


def train_step(state: TrainState, grid: PointGrid, batch: Dict,
               blur_kernels: Optional[torch.Tensor], cfg: Config,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               img_feat_staged=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One forward, one backward, both Adams.  Returns (state, loss
    items); the state's tensors are updated in place.  With
    `img_feat_staged` (PyramidCache.get_stack's maps and the images) it is
    the cached step."""
    items, g_net, g_table = loss_and_grads(state, grid, batch, blur_kernels,
                                           cfg, generator, noise,
                                           img_feat_staged)
    return apply_updates(state, g_net, g_table, cfg), items
