"""Camera-path video CLI (JAX: hybridneuralrendering_tpu/cli/render_vid.py;
reference run/render_vid.py).

Loads a scene's newest checkpoint, renders every pose of a camera path
through serve.render_full_frame and writes the frames as PNGs and a video:
a spherical orbit for a NeRF-synthetic scene (NerfSynthScene.render_path),
a closed fly-through interpolated through every `--key-stride`-th training
pose for a ScanNet scene (data/paths.gen_render_path).  The artefacts are
the JAX CLI's: `<checkpoints-dir>/<name>_vid/{log.txt,
images/step-NNNN-path.png, video.*}`.  The video needs `imageio` (mp4 with
ffmpeg, else a GIF); without it the call ends with ModuleNotFoundError
after the frames are written, as the JAX CLI's does.  Runs on the card
unless `--device cpu` is given:

    python -m hybridneuralrendering_tpu_torch.cli.render_vid --preset \\
        scannet_full --data-root <scans> --scan scene0241_01 \\
        --checkpoints-dir <ckpts>

The config is the JAX CLI's (the scan passed to presets named scannet*).
The scene layout follows cli.test.scene_class: the Blender layout for the
nerf* and fixture_nerf* presets, where the JAX CLI reads a fixture_nerf*
scene as ScanNet's and fails.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from hybridneuralrendering_tpu_torch import config as C
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.cli.test import scene_class
from hybridneuralrendering_tpu_torch.data import sampling
from hybridneuralrendering_tpu_torch.data.paths import gen_render_path
from hybridneuralrendering_tpu_torch.data.scannet import (ScannetScene,
                                                         _np_raydir)
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt_mod
from hybridneuralrendering_tpu_torch.utils.visualizer import Visualizer


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="nerf_synth_points")
    p.add_argument("--data-root", required=True)
    p.add_argument("--scan", default="lego")
    p.add_argument("--checkpoints-dir", default="./checkpoints")
    p.add_argument("--name", default=None)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--radius", type=float, default=4.0,
                   help="orbit radius (NeRF-synthetic)")
    p.add_argument("--phi", type=float, default=-30.0)
    p.add_argument("--key-stride", type=int, default=10,
                   help="every k-th training pose keys the ScanNet path")
    p.add_argument("--fps", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card)")
    return p


class PathView:
    """Batches of a dataset's frame 0 (its nearest views among them) seen
    from the poses of a path."""

    def __init__(self, base, poses):
        self.base, self.poses = base, poses
        self.height, self.width = base.height, base.width
        self.id_list = list(range(len(poses)))

    def get_batch(self, idx: int, rng=None,
                  pixelcoords: Optional[np.ndarray] = None) -> Dict:
        """Frame 0's batch at `pixelcoords` (all pixels when None) with the
        camera of pose `idx`."""
        if pixelcoords is None:
            pixelcoords = sampling.full_image_grid(self.height, self.width)
        c2w = self.poses[idx]
        b = self.base.get_batch(0, pixelcoords=pixelcoords)
        camrot, campos = c2w[:3, :3], c2w[:3, 3]
        raydir = _np_raydir(pixelcoords, self.base.intrinsic,
                            camrot).reshape(-1, 3)
        b.update({"campos": campos.astype(np.float32),
                  "camrotc2w": camrot.astype(np.float32),
                  "raydir": raydir.astype(np.float32)})
        return b


def render_pose_path(params, points, grid, base_ds, poses, cfg: C.Config,
                     vis: Visualizer, tag: str = "path", fps: int = 20,
                     device="cuda") -> Optional[str]:
    """Render every pose as a whole frame, save it as
    images/step-NNNN-<tag>.png, log it, then write the video
    (Visualizer.gen_video) and return its path."""
    path_ds = PathView(base_ds, poses)
    for i in range(len(poses)):
        img = serve.render_full_frame(params, points, grid,
                                      path_ds.get_batch(i), cfg,
                                      device=device)
        vis.save_image(img, i, tag)
        vis.log(f"rendered {tag} frame {i + 1}/{len(poses)}")
    return vis.gen_video(fps=fps)


def scene_path_poses(ds, args) -> List[np.ndarray]:
    """The camera path of the dataset family: the NeRF-synthetic orbit, or
    the fly-through of every key_stride-th ScanNet training pose (all of
    them when that leaves fewer than two)."""
    if hasattr(ds, "render_path"):
        return ds.render_path(args.frames, args.phi, args.radius)
    keys = [ds._pose(vid) for vid in ds.train_id_list[::args.key_stride]]
    if len(keys) < 2:
        keys = [ds._pose(vid) for vid in ds.train_id_list]
    return list(gen_render_path(np.stack(keys), args.frames))


def preset_config(args) -> C.Config:
    """The JAX CLI's rule: the scan goes to presets named scannet*."""
    if "scannet" in args.preset:
        return C.PRESETS[args.preset](args.scan)
    return C.PRESETS[args.preset]()


def main(argv=None) -> Optional[str]:
    """Render the path; returns the video's path."""
    args = build_argparser().parse_args(argv)
    dev = resolve(args.device)
    cfg = preset_config(args)
    name = args.name or cfg.name
    vis = Visualizer(args.checkpoints_dir, name + "_vid")
    ckpt_dir = os.path.join(args.checkpoints_dir, name, "ckpt")
    # ScanNet keys its path by the training poses; an orbit needs only the
    # test split's intrinsics
    scene = scene_class(args.preset)
    split = "train" if scene is ScannetScene else "test"
    ds = scene(args.data_root, args.scan, cfg, split)

    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ts, _ = ckpt_mod.load_checkpoint(latest, cfg, device=dev)
    grid = VG.grid_of(ts.points.xyz, ts.points.mask, cfg.querier)

    poses = scene_path_poses(ds, args)
    out = render_pose_path(ts.params, ts.points, grid, ds, poses, cfg, vis,
                           fps=args.fps, device=dev)
    vis.log(f"video written: {out}")
    return out


if __name__ == "__main__":
    main()
