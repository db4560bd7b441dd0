"""Scene-editing CLI (JAX: hybridneuralrendering_tpu/cli/edit.py;
reference run/editiing.py).

Loads the newest checkpoint of each part (a run name under
`--checkpoints-dir`), keeps the live points an optional index file names,
moves them by an optional rigid 4x4 transform, merges the parts into one
cloud and renders it along an orbit around its centroid.  A part moved by
rotation R carries rw2c = R^T on each of its points: the aggregator turns
the point offsets and view directions back into the frame the part was
trained in (models/aggregator.apply's sampled_rw2c).  The first part's
networks render the merge; the render has no source views, so the image
branch is off.  Artefacts are the JAX CLI's: `<checkpoints-dir>/
<out-name>/{log.txt, points/step-0.txt, images/step-NNNN-edited.png,
video.*}`; without `imageio` the call ends with ModuleNotFoundError after
the frames, as the JAX CLI's does.  Runs on the card unless `--device cpu`
is given:

    python -m hybridneuralrendering_tpu_torch.cli.edit --preset serve \\
        --checkpoints-dir <ckpts> --parts sceneA sceneA \\
        --index-files all.txt half.txt --transforms id.txt moved.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch import config as C
from hybridneuralrendering_tpu_torch.cli.render_vid import render_pose_path
from hybridneuralrendering_tpu_torch.data.nerf_synth import pose_spherical
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt_mod
from hybridneuralrendering_tpu_torch.utils.visualizer import Visualizer

# the per-point attributes a part hands to the merge
PART_ATTRS = ("xyz", "embedding", "conf", "color", "dirs")


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="scannet_full")
    p.add_argument("--checkpoints-dir", default="./checkpoints")
    p.add_argument("--parts", nargs="+", required=True,
                   help="run names of part checkpoints")
    p.add_argument("--index-files", nargs="+", default=None,
                   help="optional per-part point-index .txt selections")
    p.add_argument("--transforms", nargs="+", default=None,
                   help="per-part SE(3) .txt files (4x4 row-major)")
    p.add_argument("--out-name", default="edited")
    p.add_argument("--render-frames", type=int, default=24,
                   help="frames of the merged-scene render (0 = skip)")
    p.add_argument("--radius", type=float, default=3.0,
                   help="orbit radius around the merged cloud's centroid")
    p.add_argument("--phi", type=float, default=-25.0)
    p.add_argument("--image-hw", type=int, nargs=2, default=None,
                   help="render resolution (default: preset image_hw)")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card)")
    return p


class OrbitBase:
    """The dataset an orbit render reads: intrinsics (focal 0.8 W, centred)
    and the background colour; the poses come from the orbit."""

    def __init__(self, cfg: C.Config, hw: Optional[Tuple[int, int]] = None):
        self.height, self.width = hw or cfg.image_hw
        f = 0.8 * self.width
        self.intrinsic = np.array(
            [[f, 0, self.width / 2], [0, f, self.height / 2], [0, 0, 1]],
            np.float32)
        self.bg = np.asarray(cfg.render.bg_color, np.float32)

    def get_batch(self, idx, rng=None, pixelcoords=None) -> Dict:
        return {"bg_color": self.bg}


def load_part(ckpt_dir: str, cfg: C.Config, index_file: Optional[str] = None,
              transform: Optional[str] = None, device="cuda"):
    """(parameters on `device`, host attribute arrays) of the newest
    checkpoint under `ckpt_dir`: the live points, those the index file
    names where one is given, moved by the transform's T = [R t] to
    xyz @ R^T + t with rw2c = R^T each (the identity without one)."""
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ts, _ = ckpt_mod.load_checkpoint(latest, cfg, device=device)
    pts = ts.points
    sel = np.nonzero(pts.mask.cpu().numpy())[0]
    if index_file:
        idx = np.loadtxt(index_file, dtype=np.int64).reshape(-1)
        sel = sel[np.isin(sel, idx)]
    attrs = {k: getattr(pts, k).cpu().numpy()[sel] for k in PART_ATTRS}
    n = len(sel)
    if transform is not None:
        T = np.loadtxt(transform).reshape(4, 4).astype(np.float32)
        R, t = T[:3, :3], T[:3, 3]
        attrs["xyz"] = attrs["xyz"] @ R.T + t
        attrs["rw2c"] = np.tile(R.T[None], (n, 1, 1)).astype(np.float32)
    else:
        attrs["rw2c"] = np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))
    return ts.params, attrs


def merge_parts(parts: List[Dict[str, np.ndarray]], cfg: C.Config,
                device="cuda") -> npts.NeuralPoints:
    """One NeuralPoints of the parts' points in order, with their rw2c and
    the identity in the free slots.  A merge past cfg's capacity gets the
    next multiple of 1,024."""
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    pcfg = cfg.points
    if len(cat["xyz"]) > pcfg.num_points:
        pcfg = dataclasses.replace(
            pcfg, num_points=-(-len(cat["xyz"]) // 1024) * 1024)
    points = npts.init_from_arrays(
        cat["xyz"], pcfg, embedding=cat["embedding"], conf=cat["conf"],
        color=cat["color"], dirs=cat["dirs"], device=device)
    rw2c = np.tile(np.eye(3, dtype=np.float32)[None],
                   (points.capacity, 1, 1))
    rw2c[: len(cat["rw2c"])] = cat["rw2c"]
    return dataclasses.replace(
        points, rw2c=torch.as_tensor(rw2c, device=points.table.device))


def orbit_poses(centroid: np.ndarray, frames: int, phi: float,
                radius: float) -> List[np.ndarray]:
    """`frames` camera-to-world poses on a pose_spherical orbit, in
    OpenCV axes (y down, z forward), around `centroid`."""
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    poses = []
    for th in np.linspace(-180, 180, frames + 1)[:-1]:
        c2w = (pose_spherical(float(th), phi, radius) @ flip).astype(
            np.float32)
        c2w[:3, 3] += centroid
        poses.append(c2w)
    return poses


def preset_config(preset: str) -> C.Config:
    """The JAX CLI's rule: presets named scannet* take the scan "edited"."""
    if preset.startswith("scannet"):
        return C.PRESETS[preset]("edited")
    return C.PRESETS[preset]()


def main(argv=None):
    """Merge, dump and render; returns (parameters, merged points, grid)."""
    args = build_argparser().parse_args(argv)
    dev = resolve(args.device)
    cfg = preset_config(args.preset)
    vis = Visualizer(args.checkpoints_dir, args.out_name)

    parts, params = [], None
    for i, part in enumerate(args.parts):
        ckpt_dir = os.path.join(args.checkpoints_dir, part, "ckpt")
        idx = args.index_files[i] if args.index_files else None
        trf = args.transforms[i] if args.transforms else None
        p_params, attrs = load_part(ckpt_dir, cfg, idx, trf, device=dev)
        params = params or p_params  # the first part's networks render
        parts.append(attrs)
        vis.log(f"part {part}: {len(attrs['xyz'])} points"
                + (f" (transformed by {trf})" if trf else ""))

    points = merge_parts(parts, cfg, device=dev)
    grid = VG.grid_of(points.xyz, points.mask, cfg.querier)
    live = points.mask.cpu().numpy()
    xyz = points.xyz.cpu().numpy()[live]
    vis.save_neural_points(xyz, 0, points.color.cpu().numpy()[live])
    vis.log(f"merged scene: {points.num_live} points")

    if args.render_frames > 0:
        base = OrbitBase(cfg, tuple(args.image_hw) if args.image_hw
                         else None)
        poses = orbit_poses(xyz.mean(axis=0), args.render_frames, args.phi,
                            args.radius)
        rcfg = cfg.replace(image_hw=(base.height, base.width))
        out = render_pose_path(params, points, grid, base, poses, rcfg, vis,
                               tag="edited", fps=args.fps, device=dev)
        vis.log(f"edited-scene video written: {out}")
    return params, points, grid


if __name__ == "__main__":
    main()
