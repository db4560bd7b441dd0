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

# per-ray outputs of renderer.render that a request returns
RAY_OUTPUTS = ("coarse_raycolor", "coarse_is_background", "ray_mask",
               "coarse_point_opacity")


@torch.inference_mode()
def eval_step(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
              batch: Dict, cfg: Config) -> Dict:
    """Deterministic render of one chunk (no jitter, no drop, no blur)."""
    with no_tf32():
        return renderer.render(params, points, grid, batch, cfg)


@torch.inference_mode()
def render_rays(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
                request: Dict, cfg: Config) -> Dict:
    """Render every ray of `request` in chunks of cfg.sampling.eval_rays.
    Returns RAY_OUTPUTS concatenated over the request's rays."""
    raydir = request["raydir"]
    chunk = cfg.sampling.eval_rays
    outs = {k: [] for k in RAY_OUTPUTS}
    with no_tf32():
        img_feat_n = None
        if cfg.agg.use_nearest > 0 and "images_nearest" in request:
            img_feat_n = renderer.compute_image_features(
                params, cfg, request["images_nearest"])
        for start in range(0, raydir.shape[0], chunk):
            batch = dict(request, raydir=raydir[start:start + chunk])
            out = renderer.render(params, points, grid, batch, cfg,
                                  img_feat_n=img_feat_n)
            for k in RAY_OUTPUTS:
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
    12,288 of 16,384 rays at 480x640."""
    if cfg.render.bgmodel.endswith("plane"):
        raise NotImplementedError("plane backgrounds (bg_ray) are not "
                                  "ported yet")
    H, W = cfg.image_hw
    request = device_batch(batch, device)
    if request["raydir"].shape[0] != H * W:
        raise ValueError(f"a frame of {H}x{W} has {H * W} rays, the batch "
                         f"{request['raydir'].shape[0]}")
    out = render_rays(params, points, grid, request, cfg)
    return out["coarse_raycolor"].reshape(H, W, 3)
