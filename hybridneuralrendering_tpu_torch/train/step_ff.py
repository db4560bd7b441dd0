"""Feed-forward training: the MVS networks regenerate the point cloud every
step and train with the renderer (JAX:
hybridneuralrendering_tpu/train/step_ff.py; reference
models/mvs_points_volumetric_model.py:49-152).

A step: the group's depth (learned ProbNet volume, or the pretrained
MVSNet) -> unprojection -> query_embedding -> a masked NeuralPoints of
M = h * w rows whose five attributes all train, xyz included -> the query
grid, built from the detached xyz on a pinned geometry (its tables only
give neighbour ids, as the reference's CUDA querier) -> the non-hybrid
render (the ray batch carries no nearest views) -> the losses without
blur or frame weight -> backward -> two Adams: the renderer's parameters
at `lr`, every leaf of the MVS networks at `mvs_lr` (the reference's
third group), batch-norm statistics included, since the eval-mode batch
norm reads them and JAX differentiates them.  The gradient reaches the
MVS networks through the gather's segment sum over the generated table,
the bilinear weights of the embedding query and the confidence gather.

Float32 convolutions run without TF32 (device.no_tf32).  The checkpoint
`ff_{step:08d}.npz` holds the state's leaves in JAX's tree_leaves order
(np.savez's arr_0, arr_1, ...): the step, the parameters, the present MVS
parts, then for each Adam optax's (ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count)); a dict's leaves in sorted-key order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.device import no_tf32, resolve
from hybridneuralrendering_tpu_torch.models import losses as losses_mod
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.mvs import point_gen
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
from hybridneuralrendering_tpu_torch.train.state import AdamState, tree_map
from hybridneuralrendering_tpu_torch.train.step import adam_tree

# the ray batch keys of a feed-forward step (JAX cli/train.py:269)
RAY_KEYS = ("campos", "camrotc2w", "raydir", "gt_image", "bg_color")


@dataclasses.dataclass
class FFTrainState:
    step: int
    params: Dict                            # renderer (the lr group)
    mvs_params: point_gen.MvsPointsParams   # MVS nets (the mvs_lr group)
    opt_net: AdamState
    opt_mvs: AdamState


def create_ff_state(params: Dict, mvs_params: point_gen.MvsPointsParams,
                    cfg: Config, device="cuda") -> FFTrainState:
    """Step 0 on `device` (the card unless the caller asks for the CPU),
    both Adams' moments zero."""
    dev = resolve(device)

    def to(x):
        return x.to(dev, torch.float32)
    params = tree_map(to, params)
    mvs_params = point_gen.map_params(to, mvs_params)
    return FFTrainState(
        step=0, params=params, mvs_params=mvs_params,
        opt_net=AdamState(tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params)),
        opt_mvs=AdamState(point_gen.map_params(torch.zeros_like, mvs_params),
                          point_gen.map_params(torch.zeros_like,
                                               mvs_params)))


def table_of(feature_dim: int, xyz: torch.Tensor, embedding: torch.Tensor,
             conf: torch.Tensor, color: torch.Tensor,
             dirs: torch.Tensor) -> torch.Tensor:
    """The stacked point table [n, table_width] of neural_points, built
    differentiably from per-attribute tensors."""
    n = xyz.shape[0]
    parts = [p.reshape(n, -1) for p in (xyz, embedding, conf, color, dirs)]
    used = sum(p.shape[1] for p in parts)
    pad = xyz.new_zeros((n, npts.table_width(feature_dim) - used))
    return torch.cat(parts + [pad], dim=1)


def generate_points(mvs_params: point_gen.MvsPointsParams, group: Dict,
                    cfg: Config, num_depths: int, learned: bool,
                    conf_thresh: float) -> npts.NeuralPoints:
    """The group's points (JAX step_ff.py:61-89): depth -> unprojection ->
    query_embedding, as a masked NeuralPoints of M = h * w rows (the
    reference view's depth map), every attribute trainable.  group:
    "images" [V, H, W, 3], "w2cs" [V, 4, 4], "intrinsic" [3, 3] and
    optionally "depth_gt" [H, W]."""
    images, intr, w2cs = group["images"], group["intrinsic"], group["w2cs"]
    cam_xyz, conf, mask = point_gen.gen_points(
        mvs_params, images, intr, w2cs, cfg.render.near_plane,
        cfg.render.far_plane, num_depths=num_depths,
        depth_gt=group.get("depth_gt"), conf_thresh=conf_thresh,
        learned=learned)
    c2ws = torch.linalg.inv(w2cs)
    emb, color, dirs, conf_col = point_gen.query_embedding(
        mvs_params, cam_xyz, images, c2ws, w2cs, intr, 0, confidence=conf)
    ones = torch.ones_like(cam_xyz[..., :1])
    xyz_w = (torch.cat([cam_xyz, ones], -1) @ c2ws[0].T)[..., :3]
    fd = cfg.points.feature_dim
    return npts.NeuralPoints(
        table=table_of(fd, xyz_w, emb[:, :fd], conf_col, color, dirs),
        mask=mask, num_live=int(mask.sum()), feature_dim=fd,
        trainable=(True, True, True, True, True))


def ff_loss_fn(params: Dict, mvs_params: point_gen.MvsPointsParams,
               group: Dict, ray_batch: Dict, geom: VG.GridGeometry,
               cfg: Config, noise: torch.Tensor, num_depths: int,
               learned: bool, conf_thresh: float
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The feed-forward loss (JAX step_ff.py:91-108).  `noise`
    [R, z_depth_dim] in [0, 1) jitters the candidates."""
    with record_function("train.ff_points"):
        points = generate_points(mvs_params, group, cfg, num_depths,
                                 learned, conf_thresh)
    with record_function("train.ff_grid"):
        grid = VG.build_grid(points.xyz.detach(), points.mask, geom,
                             cfg.querier)
    out = renderer.render(params, points, grid, ray_batch, cfg, train=True,
                          noise=noise)
    total, items = losses_mod.compute_losses(out, ray_batch["gt_image"],
                                             cfg.loss, None)
    items["num_points"] = torch.tensor(float(points.num_live))
    return total, items


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().requires_grad_(True)


def _grad(x: torch.Tensor) -> torch.Tensor:
    return x.grad if x.grad is not None else torch.zeros_like(x)


def loss_and_grads_ff(state: FFTrainState, group: Dict, ray_batch: Dict,
                      geom: VG.GridGeometry, cfg: Config,
                      noise: torch.Tensor, num_depths: int, learned: bool,
                      conf_thresh: float):
    """(items, the renderer's gradients, the MVS networks' gradients as an
    MvsPointsParams): a leaf that takes no gradient gets zeros, as
    jax.grad gives it."""
    params = tree_map(_leaf, state.params)
    mvs = point_gen.map_params(_leaf, state.mvs_params)
    with no_tf32():
        with record_function("train.forward"):
            total, items = ff_loss_fn(params, mvs, group, ray_batch, geom,
                                      cfg, noise, num_depths, learned,
                                      conf_thresh)
        with record_function("train.backward"):
            total.backward()
    return ({k: v.detach() for k, v in items.items()},
            tree_map(_grad, params), point_gen.map_params(_grad, mvs))


def train_step_ff(state: FFTrainState, group: Dict, ray_batch: Dict,
                  geom: VG.GridGeometry, cfg: Config, noise: torch.Tensor,
                  num_depths: int = 64, learned: bool = True,
                  conf_thresh: float = 0.0
                  ) -> Tuple[FFTrainState, Dict[str, torch.Tensor]]:
    """One feed-forward step (JAX step_ff.py:111-132): the renderer's Adam
    at lr, the MVS networks' at mvs_lr, in place.  Returns (state,
    items)."""
    items, g_net, g_mvs = loss_and_grads_ff(state, group, ray_batch, geom,
                                            cfg, noise, num_depths, learned,
                                            conf_thresh)
    o = cfg.optim
    with record_function("adam.net"):
        adam_tree(state.params, g_net, state.opt_net, o.lr, o)
    with record_function("adam.mvs"):
        adam_tree(state.mvs_params, g_mvs, state.opt_mvs, o.mvs_lr, o)
    state.step += 1
    return state, items


# -- checkpoint --------------------------------------------------------------

def _jax_order(tree: Any, moment: bool = False) -> List[Any]:
    """The leaves of `tree` as jax.tree_util.tree_leaves orders them: dict
    keys sorted, lists and tuples in order, None no leaf.  A non-tensor
    leaf (attention's int num_heads) is its value, or optax's int32 zero
    in a moment tree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_order(tree[k], moment)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_order(v, moment)]
    if torch.is_tensor(tree):
        return [tree]
    return [np.int32(0) if moment else tree]


def _count(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def ff_leaves(ffs: FFTrainState) -> List[Any]:
    """The state's leaves in JAX's FFTrainState order."""
    out = [_count(ffs.step)] + _jax_order(ffs.params) \
        + _jax_order(ffs.mvs_params)
    for opt in (ffs.opt_net, ffs.opt_mvs):
        out += [_count(opt.count)] + _jax_order(opt.mu, True) \
            + _jax_order(opt.nu, True) + [_count(opt.count)]
    return out


def save_ff_checkpoint(ckpt_dir: str, ffs: FFTrainState) -> str:
    """Write `<ckpt_dir>/ff_{step:08d}.npz` and return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ff_{int(ffs.step):08d}.npz")
    np.savez(path, *[x.detach().cpu().numpy() if torch.is_tensor(x)
                     else np.asarray(x) for x in ff_leaves(ffs)])
    return path


def _refill(tree: Any, it: Iterator[np.ndarray], dev) -> Any:
    """`tree` with its tensors replaced, in JAX's leaf order, by the next
    arrays of `it` (float32 on `dev`); a non-tensor leaf (an int of the
    configuration) uses up its array and keeps the template's value."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        filled = {k: _refill(tree[k], it, dev) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_refill(v, it, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_refill(v, it, dev) for v in tree]
    arr = next(it)
    if torch.is_tensor(tree):
        return torch.tensor(arr, dtype=torch.float32, device=dev)
    return tree


def load_ff_checkpoint(path: str, template: FFTrainState,
                       device="cuda") -> FFTrainState:
    """The state of an ff checkpoint written by either package, shaped as
    `template` (the same configuration's fresh state), on `device`."""
    dev = resolve(device)
    with np.load(path) as data:
        arrays = [data[k] for k in data.files]
    it = iter(arrays)
    step = int(next(it))
    params = _refill(template.params, it, dev)
    mvs = _refill(template.mvs_params, it, dev)
    adams = []
    for opt in (template.opt_net, template.opt_mvs):
        count = int(next(it))
        mu = _refill(opt.mu, it, dev)
        nu = _refill(opt.nu, it, dev)
        next(it)                      # the schedule's count, = count
        adams.append(AdamState(mu, nu, count))
    if next(it, None) is not None:
        raise ValueError(f"{path} holds more leaves than the template")
    return FFTrainState(step=step, params=params, mvs_params=mvs,
                        opt_net=adams[0], opt_mvs=adams[1])
