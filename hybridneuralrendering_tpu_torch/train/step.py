"""One training step (JAX: hybridneuralrendering_tpu/train/step.py,
`train_step`).

render (train mode: jittered candidates, image-feature drop) -> blur
degradation of the predicted colours (the learnable kernel's MLP or the
kernel bank) -> masked losses with the frame weight -> backward -> two
Adams: the point table through the Adam kernel (ops/adam.py) at `plr`, the
network parameters (the blur MLP's among them) at `lr` through
torch._foreach_* operations that repeat optax's arithmetic.  Without
`img_feat_staged` the pyramid CNN runs inside the step (the uncached,
CNN-burst step); with it the step reads cached stage maps
(train/pyramid_cache.py), the CNN's gradient is zero, and both Adams still
run over every leaf, as optax does: after an uncached step the CNN moves
on a cached step by its first moment alone.

`train_step_multi` takes F frames' batches in one optimizer step: the
loss is the mean of the frames' totals, and the frames run one after
another, each backward adding the gradient of its total / F, so one frame's
graph is alive at a time.  The data-parallel steps of parallel/ reuse the
pieces: `loss_of_render` (the blur and the losses after renderer.render),
`loss_and_grads`' `loss` argument and `frames_backward`.  The step
updates the state's tensors in place and returns the state.  Float32
convolutions run without TF32 (device.no_tf32), as in serving.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from hybridneuralrendering_tpu_torch.config import Config, OptimConfig
from hybridneuralrendering_tpu_torch.core import bg_plane
from hybridneuralrendering_tpu_torch.device import HOST_KEYS, no_tf32
from hybridneuralrendering_tpu_torch.models import blur as blur_mod
from hybridneuralrendering_tpu_torch.models import losses as losses_mod
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.ops.adam import adam_scalars, adam_table
from hybridneuralrendering_tpu_torch.ops.voxel_grid import PointGrid
from hybridneuralrendering_tpu_torch.train.state import (
    AdamState, TrainState, lr_schedule, tree_leaves, tree_map)


def device_batch(batch: Dict) -> Dict:
    """The batch without its host-only keys (frame and view ids)."""
    return {k: v for k, v in batch.items() if k not in HOST_KEYS}


def maybe_add_bg_ray(batch: Dict, points: npts.NeuralPoints,
                     cfg: Config) -> Dict:
    """The plane-background preprocessing (JAX step.maybe_add_bg_ray;
    reference run/train_ft.py:972-980): when render.bgmodel ends with
    'plane' and the batch carries the plane keys and the nearest views,
    the plane keys give way to a per-ray `bg_ray` [R, 3] on the points'
    device (core/bg_plane.compute_bg_ray), which the renderer composites
    under the background transmission.  Otherwise the batch unchanged.
    Leaves may be numpy arrays (a host batch) or tensors."""
    if (not cfg.render.bgmodel.endswith("plane")
            or "plane_pnt" not in batch or "images_nearest" not in batch):
        return batch
    dev = points.xyz.device

    def t(k):
        return torch.as_tensor(batch[k], dtype=torch.float32, device=dev)

    bg = bg_plane.compute_bg_ray(
        t("campos"), t("raydir"), t("plane_pnt"), t("plane_normal"),
        t("plane_color"), t("images_nearest"),
        torch.linalg.inv(t("c2w_nearest")), t("intrinsic_nearest"),
        points.xyz, points.mask)
    out = {k: v for k, v in batch.items() if not k.startswith("plane_")}
    out["bg_ray"] = bg
    return out


def loss_of_render(params: Dict, out: Dict, batch: Dict, cfg: Config,
                   blur_kernels: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of a render `out` of `batch`'s rays: the
    predicted colours degraded (by the learnable blur kernel's MLP when the
    aggregator has one, else by the best bank kernel per patch; `out`
    holds every ray of the batch's patches), then the masked losses with
    the frame weight, and the rays' hit share.  The seam after
    renderer.render: parallel/mesh.py gathers the ray shards' renders and
    calls it on the whole batch."""
    pn = cfg.sampling.dilation_patch_num
    ps = cfg.sampling.dilation_patch_size
    if cfg.agg.learnable_blur_kernel:
        with record_function("train.blur"):
            out["coarse_raycolor"] = blur_mod.learnable_blur_update(
                params["aggregator"], cfg.agg, out["coarse_raycolor"],
                batch["gt_image"], pn, ps)
    elif cfg.blur.add_blur_sim and blur_kernels is not None:
        with record_function("train.blur"):
            out["coarse_raycolor"] = blur_mod.blur_bank_update(
                out["coarse_raycolor"], batch["gt_image"], blur_kernels,
                pn, ps)
    fw = batch.get("frame_weight") if cfg.loss.use_frame_weight else None
    total, items = losses_mod.compute_losses(out, batch["gt_image"],
                                             cfg.loss, fw)
    items["ray_hit_frac"] = torch.mean(out["ray_mask"].to(torch.float32))
    return total, items


def loss_fn(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
            batch: Dict, cfg: Config, blur_kernels: Optional[torch.Tensor],
            noise: Optional[torch.Tensor] = None, img_feat_staged=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = renderer.render(params, points, grid, batch, cfg, train=True,
                          noise=noise, img_feat_staged=img_feat_staged)
    return loss_of_render(params, out, batch, cfg, blur_kernels)


def candidate_noise(batch: Dict, cfg: Config, generator, noise):
    """`noise` when given, else [R, z_depth_dim] drawn from `generator`
    on the rays' device."""
    if noise is not None:
        return noise
    raydir = batch["raydir"]
    return torch.rand((raydir.shape[0], cfg.querier.z_depth_dim),
                      generator=generator, device=raydir.device)


def grad_leaves(state: TrainState):
    """Leaf copies of the network parameters and (when an attribute
    trains) the point table that collect the gradients of backward."""
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      state.params)
    points = state.points
    if state.opt_pts is not None:
        points = dataclasses.replace(
            points, table=points.table.detach().requires_grad_(True))
    return params, points


def leaf_grads(state: TrainState, params: Dict, points: npts.NeuralPoints):
    """(network gradients, table gradient or None) that backward left on
    grad_leaves' leaves; zeros where a leaf took none."""
    g_net = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), params)
    g_table = None
    if state.opt_pts is not None:
        g_table = points.table.grad if points.table.grad is not None \
            else torch.zeros_like(points.table)
    return g_net, g_table


def loss_and_grads(state: TrainState, grid: PointGrid, batch: Dict,
                   blur_kernels: Optional[torch.Tensor], cfg: Config,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   img_feat_staged=None, loss: Callable = loss_fn):
    """The training loss of `state` on `batch` and its gradients.

    Returns (items, grads of the network parameters (the params' nesting),
    grad of the point table or None when no attribute trains).  `noise`
    [R, z_depth_dim] in [0, 1) jitters the candidates; when None it is
    drawn from `generator`.  `img_feat_staged` = (images_nearest,
    (s1, s2, s3)) makes it a cached step.  `loss` takes loss_fn's
    arguments (parallel/mesh.py passes its ray-sharded loss)."""
    batch = device_batch(batch)
    noise = candidate_noise(batch, cfg, generator, noise)
    params, points = grad_leaves(state)
    with no_tf32():
        with record_function("train.forward"):
            total, items = loss(params, points, grid, batch, cfg,
                                blur_kernels, noise, img_feat_staged)
        with record_function("train.backward"):
            total.backward()
    return ({k: v.detach() for k, v in items.items()},) + leaf_grads(
        state, params, points)


def frames_backward(params: Dict, points: npts.NeuralPoints,
                    grid: PointGrid, batches: Dict,
                    blur_kernels: Optional[torch.Tensor], cfg: Config,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    img_feat_staged=None, num_frames: Optional[int] = None
                    ) -> List[Dict[str, torch.Tensor]]:
    """multi_loss_and_grads' loop: each frame of `batches` (a leading
    frame axis on every leaf) renders and adds the gradient of its total /
    num_frames (default: the frames given) to the leaves' .grad, one
    frame's graph alive at a time.  Returns each frame's loss items."""
    F = batches["raydir"].shape[0]
    num_frames = num_frames or F
    per_frame: List[Dict[str, torch.Tensor]] = []
    for f in range(F):
        batch = {k: v[f] for k, v in batches.items()}
        staged = None
        if img_feat_staged is not None:
            images, stages = img_feat_staged
            staged = (images[f], tuple(s[f] for s in stages))
        noise_f = candidate_noise(batch, cfg, generator,
                                  None if noise is None else noise[f])
        with no_tf32():
            with record_function("train.forward"):
                total, items = loss_fn(params, points, grid, batch, cfg,
                                       blur_kernels, noise_f, staged)
            with record_function("train.backward"):
                (total / num_frames).backward()
        items.pop("ray_hit_frac")
        per_frame.append({k: v.detach() for k, v in items.items()})
    return per_frame


def multi_loss_and_grads(state: TrainState, grid: PointGrid, batches: Dict,
                         blur_kernels: Optional[torch.Tensor], cfg: Config,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         img_feat_staged=None):
    """The loss of F frames (JAX step.multi_loss_fn) and its gradients.

    `batches` holds every leaf with a leading frame axis F (stack_batches);
    `noise` [F, R, z_depth_dim] gives each frame its candidate noise (drawn
    per frame from `generator` when None); `img_feat_staged` = (images
    [F, V, H, W, 3], (s1, s2, s3) each [F, V, ...]) makes it a cached
    step.  The frames run one after another and each backward adds the
    gradient of its total / F.  Returns (items: each loss item's mean over
    the frames, the network gradients, the table gradient or None)."""
    batches = device_batch(batches)
    params, points = grad_leaves(state)
    per_frame = frames_backward(params, points, grid, batches, blur_kernels,
                                cfg, generator, noise, img_feat_staged)
    items = {k: torch.mean(torch.stack([it[k] for it in per_frame]))
             for k in per_frame[0]}
    return (items,) + leaf_grads(state, params, points)


@torch.no_grad()
def adam_tree(params, grads, opt: AdamState, base_lr: float,
              o: OptimConfig) -> None:
    """optax.adam under lr_schedule(base_lr) over the tensors of `params`
    (any nesting tree_leaves walks; `grads` and the moments nested
    alike), in place: the arithmetic of ops/adam.adam_table_plain as
    torch._foreach_* operations."""
    s = adam_scalars(opt.count, opt.count, lr_schedule(base_lr, o), o.beta1,
                     o.beta2)
    p, g = tree_leaves(params), tree_leaves(grads)
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


def _adam_net(state: TrainState, g_net: Dict, cfg: Config) -> None:
    adam_tree(state.params, g_net, state.opt_net, cfg.optim.lr, cfg.optim)


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


def train_step_multi(state: TrainState, grid: PointGrid, batches: Dict,
                     blur_kernels: Optional[torch.Tensor], cfg: Config,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     img_feat_staged=None
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step over F frames (JAX step.train_step_multi): the
    frames' gradients of the mean total, then both Adams once.  Arguments
    as multi_loss_and_grads; returns (state, the items' frame means)."""
    items, g_net, g_table = multi_loss_and_grads(
        state, grid, batches, blur_kernels, cfg, generator, noise,
        img_feat_staged)
    return apply_updates(state, g_net, g_table, cfg), items


def stack_batches(batch_list: List[Dict]) -> Dict:
    """Per-frame batch dicts -> one dict with a leading frame axis on every
    leaf (JAX step.stack_batches): a key whose values include a tensor (the
    trainer's view-bank image stacks) stacks as a tensor on that tensor's
    device, any other as numpy."""
    out = {}
    for k in batch_list[0]:
        vals = [b[k] for b in batch_list]
        tensors = [v for v in vals if torch.is_tensor(v)]
        if tensors:
            dev = tensors[0].device
            out[k] = torch.stack([torch.as_tensor(v, device=dev)
                                  for v in vals])
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out
