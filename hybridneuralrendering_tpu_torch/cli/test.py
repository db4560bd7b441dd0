"""Evaluation CLI (JAX: hybridneuralrendering_tpu/cli/test.py; reference
run/test_ft.py).

Loads a scene's newest checkpoint, builds its query grid, renders every
pixel of the test split's frames (a ScanNet scene, or a Blender-layout one
under the NeRF presets), writes the frames as PNGs, logs each
frame's PSNR and rays/s, and writes the mean PSNR / SSIM / RMSE (+ LPIPS
where the `lpips` package is installed) to `scores.txt`, as the JAX CLI
does.  Runs on the card unless `--device cpu` is given:

    python -m hybridneuralrendering_tpu_torch.cli.test --preset scannet_full \\
        --data-root <scans> --scan scene0241_01 --checkpoints-dir <ckpts>

`main` also returns the scores.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import time
from typing import Dict

import torch

from hybridneuralrendering_tpu_torch import config as C
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.data.nerf_synth import NerfSynthScene
from hybridneuralrendering_tpu_torch.data.scannet import ScannetScene
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt_mod
from hybridneuralrendering_tpu_torch.utils import metrics as M
from hybridneuralrendering_tpu_torch.utils.visualizer import Visualizer


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="scannet_full")
    p.add_argument("--data-root", required=True)
    p.add_argument("--scan", default="scene0241_01")
    p.add_argument("--checkpoints-dir", default="./checkpoints")
    p.add_argument("--name", default=None)
    p.add_argument("--num-frames", type=int, default=0,
                   help="0 = all test frames")
    p.add_argument("--with-lpips", action="store_true")
    p.add_argument("--eval-chunk", type=int, default=0,
                   help="override sampling.eval_chunk_rays (0 = preset)")
    p.add_argument("--blur-mode", default="preset",
                   choices=("preset", "off", "bank", "learnable"),
                   help="must match the training run (a learnable run's "
                        "checkpoint holds the blur MLP's leaves)")
    p.add_argument("--pyramid-dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="override agg.pyramid_dtype (match the training run)")
    p.add_argument("--shading-dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="override agg.shading_dtype (match the training run)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card)")
    return p


def scene_class(preset: str):
    """The dataset class of a preset: the Blender layout for the NeRF
    presets (names starting nerf or fixture_nerf), else ScanNet's, as the
    JAX CLIs choose."""
    if preset.startswith(("nerf", "fixture_nerf")):
        return NerfSynthScene
    return ScannetScene


def preset_config(args) -> C.Config:
    preset = C.PRESETS[args.preset]
    if inspect.signature(preset).parameters:
        return preset(args.scan)
    return preset()


def apply_snapshot(cfg: C.Config, args, snap: Dict):
    """The CLI's overrides and the run_config.json snapshot's eval
    settings (blur mode, dtypes, point capacity), explicit flags winning:
    the JAX CLI's rules, so that a checkpoint evaluates under what it
    trained with.  Returns (cfg, blur_mode)."""
    blur_mode = args.blur_mode
    if blur_mode == "preset" and snap.get("blur_mode", "preset") != "preset":
        blur_mode = snap["blur_mode"]
    cfg = C.apply_blur_overrides(cfg, blur_mode)
    if args.eval_chunk:
        cfg = cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, eval_chunk_rays=args.eval_chunk))
    pyr_dt = args.pyramid_dtype or snap.get("pyramid_dtype")
    if pyr_dt is not None:
        cfg = cfg.replace(agg=dataclasses.replace(
            cfg.agg, pyramid_dtype=pyr_dt))
    sh_dt = args.shading_dtype or snap.get("shading_dtype")
    if sh_dt is not None:
        cfg = cfg.replace(agg=dataclasses.replace(
            cfg.agg, shading_dtype=sh_dt))
    if snap.get("num_points"):
        cfg = cfg.replace(points=dataclasses.replace(
            cfg.points, num_points=int(snap["num_points"])))
    return cfg, blur_mode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> Dict[str, float]:
    args = build_argparser().parse_args(argv)
    dev = resolve(args.device)
    cfg = preset_config(args)
    name = args.name or cfg.name
    ckpt_dir = os.path.join(args.checkpoints_dir, name, "ckpt")
    snap = {}
    snap_path = os.path.join(ckpt_dir, "run_config.json")
    if os.path.exists(snap_path):
        with open(snap_path) as f:
            snap = json.load(f)
    cfg, blur_mode = apply_snapshot(cfg, args, snap)
    vis = Visualizer(args.checkpoints_dir, name + "_test")
    vis.log(f"effective dtypes: pyramid={cfg.agg.pyramid_dtype} "
            f"shading={cfg.agg.shading_dtype}  blur_mode={blur_mode}  "
            f"capacity={cfg.points.num_points}"
            + ("  (from run_config.json)" if snap else ""))

    test_ds = scene_class(args.preset)(args.data_root, args.scan, cfg,
                                       "test")
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ts, best = ckpt_mod.load_checkpoint(latest, cfg, device=dev)
    vis.log(f"loaded {latest} (step {int(ts.step)}, best PSNR {best:.2f})")

    pts = ts.points
    grid = VG.grid_of(pts.xyz, pts.mask, cfg.querier)

    n = args.num_frames or len(test_ds)
    preds, gts = [], []
    for fi in range(min(n, len(test_ds))):
        t0 = time.time()
        img = serve.render_full_frame(ts.params, pts, grid,
                                      test_ds.get_batch(fi), cfg, device=dev)
        _sync(dev)
        dt = time.time() - t0
        gt = torch.as_tensor(test_ds.image(test_ds.id_list[fi]), device=dev)
        preds.append(img)
        gts.append(gt)
        vis.save_image(img, fi, "coarse_raycolor")
        vis.save_image(gt, fi, "gt_image")
        vis.log(f"frame {fi}: PSNR {M.psnr(img, gt):.3f}  "
                f"render {dt:.2f}s ({img.shape[0] * img.shape[1] / dt:.0f} "
                f"rays/s)")

    scores = M.report_metrics(preds, gts, with_lpips=args.with_lpips)
    with open(os.path.join(vis.dir, "scores.txt"), "w") as f:
        for k, v in scores.items():
            f.write(f"{k}: {v}\n")
            vis.log(f"{k}: {v:.4f}")
    return scores


if __name__ == "__main__":
    main()
