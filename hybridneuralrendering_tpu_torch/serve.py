"""Serving: deterministic eval renders of ray requests
(JAX: hybridneuralrendering_tpu/train/step.py:eval_step and
cli/test.py:render_full_frame).

A request is a batch dict (see models/renderer.render) whose 'raydir' may
hold any number of rays.  `render_rays` computes the nearest views' pyramid
features once per request, then renders the rays in chunks of
cfg.sampling.eval_rays and concatenates the per-ray outputs.
`render_full_frame` renders every pixel of a dataset frame as one request.

Float32 stays float32 on the card: matmuls keep torch's default
(torch.backends.cuda.matmul.allow_tf32 False) and both entry points run
cuDNN with allow_tf32=False, which torch would otherwise enable for
convolutions.
"""

from __future__ import annotations

from typing import Dict

import torch

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.device import device_batch, no_tf32
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.ops.voxel_grid import PointGrid
from hybridneuralrendering_tpu_torch.train.step import maybe_add_bg_ray

# the request's per-ray keys, cut into the chunks with the rays
PER_RAY = ("raydir", "bg_ray")
# per-ray outputs of renderer.render that a request returns
RAY_OUTPUTS = ("coarse_raycolor", "coarse_is_background", "ray_mask",
               "coarse_point_opacity")
# and, with prob=True, the point-growing outputs (renderer.prob_outputs)
PROB_OUTPUTS = ("ray_max_shading_opacity", "ray_max_sample_loc_w",
                "ray_max_far_dist", "shading_avg_color", "shading_avg_dir",
                "shading_avg_conf", "shading_avg_embedding")


@torch.inference_mode()
def eval_step(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
              batch: Dict, cfg: Config, prob: bool = False) -> Dict:
    """Deterministic render of one chunk (no jitter, no drop, no blur);
    `prob` adds the point-growing outputs."""
    with no_tf32():
        return renderer.render(params, points, grid, batch, cfg, prob=prob)


@torch.inference_mode()
def render_rays(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
                request: Dict, cfg: Config, prob: bool = False) -> Dict:
    """Render every ray of `request` in chunks of cfg.sampling.eval_rays
    (its PER_RAY keys cut with the rays).  Returns RAY_OUTPUTS (and
    PROB_OUTPUTS with `prob`) concatenated over the request's rays."""
    raydir = request["raydir"]
    chunk = cfg.sampling.eval_rays
    keys = RAY_OUTPUTS + (PROB_OUTPUTS if prob else ())
    outs = {k: [] for k in keys}
    with no_tf32():
        img_feat_n = None
        if cfg.agg.use_nearest > 0 and "images_nearest" in request:
            img_feat_n = renderer.compute_image_features(
                params, cfg, request["images_nearest"])
        for start in range(0, raydir.shape[0], chunk):
            batch = dict(request, **{k: request[k][start:start + chunk]
                                     for k in PER_RAY if k in request})
            out = renderer.render(params, points, grid, batch, cfg,
                                  img_feat_n=img_feat_n, prob=prob)
            for k in keys:
                outs[k].append(out[k])
    return {k: torch.cat(v) for k, v in outs.items()}


def render_full_frame(params: Dict, points: npts.NeuralPoints,
                      grid: PointGrid, batch: Dict, cfg: Config,
                      device="cuda") -> torch.Tensor:
    """Every pixel of one frame -> [H, W, 3] colours on `device` (the card
    unless the caller asks for the CPU).  `batch` is the frame's host
    batch over all cfg.image_hw pixels in row-major order, as a test
    split's ScannetScene.get_batch(idx) gives it.

    The frame is one request through render_rays, so the nearest views'
    pyramid runs once a frame.  The JAX CLI pads its last chunk to the
    full chunk by repeating the last pixel and runs the pyramid in every
    chunk; neither changes a valid pixel.  Here the last chunk is ragged:
    12,288 of 16,384 rays at 480x640.  A plane background's keys, where
    the batch has them, become its `bg_ray` (step.maybe_add_bg_ray, as
    JAX's render_full_frame does per chunk); no dataset supplies them."""
    H, W = cfg.image_hw
    request = maybe_add_bg_ray(device_batch(batch, device), points, cfg)
    if request["raydir"].shape[0] != H * W:
        raise ValueError(f"a frame of {H}x{W} has {H * W} rays, the batch "
                         f"{request['raydir'].shape[0]}")
    out = render_rays(params, points, grid, request, cfg)
    return out["coarse_raycolor"].reshape(H, W, 3)
