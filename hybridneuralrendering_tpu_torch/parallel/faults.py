"""Planted faults of the ray- and frame-sharded steps, for the checks that
must reject them (tests/test_torch_port_parallel.py, chip_smoke.py's
parallel phase).  Each replaces attributes of parallel/mesh while a
`planted(name)` block runs:

  allreduce  the gradients are not summed over the data group;
  gather     each rank's loss on its own rays and their ground truth, with
             no gather: the masked means take the shard's normalisers (the
             blur, which needs whole patches, is left out with it);
  noise      every rank renders with the noise rows 0 ... R / D, not its
             own.
"""

from __future__ import annotations

import contextlib

import torch

from hybridneuralrendering_tpu_torch.models import aggregator as agg
from hybridneuralrendering_tpu_torch.models import losses, renderer
from hybridneuralrendering_tpu_torch.parallel import mesh as pmesh


def _per_shard_loss(mesh, params, points, grid, batch, cfg, blur_kernels,
                    noise, img_feat_staged=None):
    rows = pmesh.shard_batch(batch, mesh, cfg.parallel)
    drop = pmesh.data_rows(torch.as_tensor(agg.drop_ray_mask(
        cfg.agg, batch["raydir"].shape[0], cfg.sampling.dilation_patch_num,
        cfg.sampling.dilation_patch_size), device=noise.device), mesh)
    out = renderer.render(params, points, grid, rows, cfg, train=True,
                          noise=pmesh.data_rows(noise, mesh),
                          img_feat_staged=img_feat_staged, drop_mask=drop)
    fw = batch.get("frame_weight") if cfg.loss.use_frame_weight else None
    total, items = losses.compute_losses(out, rows["gt_image"], cfg.loss, fw)
    items["ray_hit_frac"] = torch.mean(out["ray_mask"].float())
    return total, items


def _first_noise_rows(real):
    def loss(mesh, params, points, grid, batch, cfg, blur_kernels, noise,
             img_feat_staged=None):
        # rolled so that this rank's rows of the noise are rows 0 ... R / D
        n = noise.shape[0] // mesh.data_size
        return real(mesh, params, points, grid, batch, cfg, blur_kernels,
                    torch.roll(noise, mesh.data_index * n, 0),
                    img_feat_staged)
    return loss


FAULTS = {
    "allreduce": lambda: {"reduce_grads": lambda *a, **k: None},
    "gather": lambda: {"sharded_loss": _per_shard_loss},
    "noise": lambda: {"sharded_loss": _first_noise_rows(pmesh.sharded_loss)},
}


@contextlib.contextmanager
def planted(name):
    """parallel/mesh with the fault `name` (FAULTS) inside the block; None
    plants nothing."""
    patch = FAULTS[name]() if name else {}
    real = {k: getattr(pmesh, k) for k in patch}
    for k, v in patch.items():
        setattr(pmesh, k, v)
    try:
        yield
    finally:
        for k, v in real.items():
            setattr(pmesh, k, v)
