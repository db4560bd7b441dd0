"""Checkpoint preview CLI (JAX: hybridneuralrendering_tpu/cli/visualize.py;
reference run/visualize.py).

Loads a scene's newest checkpoint and renders `--frames` test frames,
evenly strided, as whole frames: `<checkpoints-dir>/<name>_vis/{log.txt,
images/step-NNNN-render.png}`, with a `frame i: PSNR x.xx` line each.  Runs
on the card unless `--device cpu` is given:

    python -m hybridneuralrendering_tpu_torch.cli.visualize --preset \\
        scannet_full --data-root <scans> --scan scene0241_01 \\
        --checkpoints-dir <ckpts>

The config is the JAX CLI's (the scan passed to presets named scannet*);
the scene is the Blender layout's for the nerf* and fixture_nerf* presets
(cli.test.scene_class), where the JAX CLI reads a fixture_nerf* scene as
ScanNet's and fails.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from hybridneuralrendering_tpu_torch import config as C
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.cli.test import scene_class
from hybridneuralrendering_tpu_torch.data import create_dataset
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
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card)")
    return p


def main(argv=None) -> Dict[int, float]:
    """Render the frames; returns {test frame index: PSNR}."""
    args = build_argparser().parse_args(argv)
    dev = resolve(args.device)
    cfg = (C.PRESETS[args.preset](args.scan)
           if args.preset.startswith("scannet") else C.PRESETS[args.preset]())
    name = args.name or cfg.name
    vis = Visualizer(args.checkpoints_dir, name + "_vis")
    ds_name = ("scannet" if scene_class(args.preset) is ScannetScene
               else "nerf_synth")
    ds = create_dataset(ds_name, args.data_root, args.scan, cfg, "test")

    ckpt_dir = os.path.join(args.checkpoints_dir, name, "ckpt")
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ts, _ = ckpt_mod.load_checkpoint(latest, cfg, device=dev)
    grid = VG.grid_of(ts.points.xyz, ts.points.mask, cfg.querier)

    psnrs = {}
    stride = max(len(ds) // max(args.frames, 1), 1)
    for i, fi in enumerate(range(0, len(ds), stride)):
        if i >= args.frames:
            break
        img = serve.render_full_frame(ts.params, ts.points, grid,
                                      ds.get_batch(fi), cfg, device=dev)
        gt = torch.as_tensor(ds.image(ds.id_list[fi]), device=dev)
        vis.save_image(img, fi, "render")
        psnrs[fi] = M.psnr(img, gt)
        vis.log(f"frame {fi}: PSNR {psnrs[fi]:.2f}")
    return psnrs


if __name__ == "__main__":
    main()
