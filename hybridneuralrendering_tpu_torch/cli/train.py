"""Per-scene training CLI (JAX: hybridneuralrendering_tpu/cli/train.py;
reference run/train_ft.py:621-1085).

    python -m hybridneuralrendering_tpu_torch.cli.train \\
        --preset scannet_full --data-root <scans> --scan scene0241_01 \\
        --checkpoints-dir <ckpts> [--max-steps N] [--device cpu]

Bootstraps the point cloud from the scene's PLY mesh (--load-points 1),
its sensor depth (2, the default) or the feed-forward MVS networks (0:
MVSNet depth per view triplet, filtered across the triplets, with
per-point embeddings; train/bootstrap), builds the query grid and
trains: uncached steps (the pyramid CNN inside) in the bursts of the
schedule, cached steps (train/pyramid_cache) between
them, with periodic evaluation, checkpoints, confidence pruning and
probe-and-grow in process (train/lifecycle).  The flags, their defaults,
the schedule, the log lines and the checkpoints are the JAX CLI's.  Runs on
the card unless `--device cpu` is given.

A step's candidate noise comes from one torch.Generator on the device,
seeded by --seed, through `step_noise`; the initial parameters, point
embeddings and MVS networks from CPU generators seeded by --seed
(`init_params`, `init_embedding`, `init_mvs`).  The JAX CLI draws them
all from jax.random keys.  --mvs-ckpt loads the pretrained MVSNet in a
reference-layout checkpoint (io/torch_import.import_mvsnet).

`--train-mode ff` trains feed-forward (train/step_ff, `train_ff`): every
step regenerates the cloud of a random view triplet through the MVS
networks, on a grid geometry pinned to the querier's ranges, and trains
them with the renderer; without --mvs-ckpt the depth is the learned
ProbNet volume's.  As in JAX, the step renders the triplet's first view
through get_batch, whose index is a position in the scene's id_list,
while the triplets hold positions in its train_id_list: the two differ
where a blur list removed frames (ROADMAP Queue 3).

`--native-prefetch N` (N > 0, dilated sampling) assembles each step's
pixels, ground truth and ray directions in the native sampler
(data/native_sampler) on N worker threads, seeded by the step index, as
the JAX CLI does: every frame of a multi-frame step gets the same pixels.
Where the sampler cannot be built the CLI raises; the JAX CLI falls back
to numpy sampling.  With another sampler the flag is ignored, as in JAX,
and a log line says so.  `--blur-mode learnable` and `scannet_learnable`
train the learnable blur kernel's MLP with the other parameters.

The NeRF presets (nerf_*, fixture_nerf_*) read a Blender-layout scene
(data/nerf_synth) and bootstrap from its fused.ply (--load-points 1).  As
in the JAX CLI, such a scene has no sensor depth, so --load-points 2 fails
with AttributeError at the bootstrap, and --native-prefetch with a dilated
NeRF preset fails with AttributeError at the first step (the native path
reads ScanNet poses).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from hybridneuralrendering_tpu_torch import config as C
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.cli.test import (preset_config,
                                                     scene_class)
from hybridneuralrendering_tpu_torch.data import native_sampler
from hybridneuralrendering_tpu_torch.data.point_init import (
    voxel_downsample_closest)
from hybridneuralrendering_tpu_torch.device import device_batch, resolve
from hybridneuralrendering_tpu_torch.io import torch_import
from hybridneuralrendering_tpu_torch.models import blur as blur_mod
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.mvs import point_gen
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
from hybridneuralrendering_tpu_torch.train import bootstrap
from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt_mod
from hybridneuralrendering_tpu_torch.train import lifecycle
from hybridneuralrendering_tpu_torch.train import pyramid_cache as pc_mod
from hybridneuralrendering_tpu_torch.train import state as state_mod
from hybridneuralrendering_tpu_torch.train import step as step_mod
from hybridneuralrendering_tpu_torch.train import step_ff
from hybridneuralrendering_tpu_torch.utils import metrics as M
from hybridneuralrendering_tpu_torch.utils.visualizer import Visualizer


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="scannet_full",
                   help="config preset name (see config.PRESETS)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--scan", default="scene0241_01")
    p.add_argument("--checkpoints-dir", default="./checkpoints")
    p.add_argument("--name", default=None, help="run name (default: preset)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--load-points", type=int, default=2,
                   help="0: feed-forward MVS, 1: ply mesh, 2: sensor depth")
    p.add_argument("--vox-res", type=int, default=900,
                   help="voxel-downsample resolution for init points")
    p.add_argument("--mvs-ckpt", default=None,
                   help="pretrained MVSNet checkpoint (reference layout, "
                        "checkpoints/MVSNet/model_000014.ckpt) for mode 0 "
                        "and --train-mode ff")
    p.add_argument("--max-groups", type=int, default=0,
                   help="cap on MVS view triplets in mode 0 (0 = all)")
    p.add_argument("--mvs-conf-thresh", type=float, default=0.8)
    p.add_argument("--mvs-num-depths", type=int, default=96)
    p.add_argument("--test-freq", type=int, default=10_000)
    p.add_argument("--save-freq", type=int, default=10_000)
    p.add_argument("--print-freq", type=int, default=40)
    p.add_argument("--prob-freq", type=int, default=None)
    p.add_argument("--prob-frames", type=int, default=0,
                   help="frames probed per grow event (0 = preset's "
                        "len(dataset)/prob_num_step rule)")
    p.add_argument("--prune-iter", type=int, default=None,
                   help="override ProbeConfig.prune_iter (steps between "
                        "conf-threshold prunes; -1 disables)")
    p.add_argument("--prune-thresh", type=float, default=None)
    p.add_argument("--lr-decay-iters", type=int, default=None,
                   help="override OptimConfig.lr_decay_iters")
    p.add_argument("--test-num", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-mode", choices=("per-scene", "ff"),
                   default="per-scene",
                   help="'ff': feed-forward training, the MVS nets "
                        "regenerate the cloud every step and train at "
                        "mvs_lr (mvs_points_volumetric_model.py:49-152)")
    p.add_argument("--native-prefetch", type=int, default=0,
                   help="worker threads of the native batch sampler "
                        "(0 = numpy sampling; dilated sampling only)")
    p.add_argument("--frames-per-step", type=int, default=1,
                   help=">1 takes several frames' ray batches into one "
                        "optimizer step (larger effective batch)")
    p.add_argument("--num-points", type=int, default=None,
                   help="override PointsConfig.num_points (point-table "
                        "capacity)")
    p.add_argument("--bootstrap-cap", type=int, default=0,
                   help="cap the bootstrap cloud at this size instead of "
                        "num_points (0 = num_points)")
    p.add_argument("--drop-box", type=float, nargs=6, default=None,
                   metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                   help="delete bootstrap points inside this world AABB "
                        "(a hole for the probe-and-grow lifecycle)")
    p.add_argument("--blur-mode", default="preset",
                   choices=("preset", "off", "bank", "learnable"),
                   help="override the preset's blur simulation")
    p.add_argument("--frame-weight", type=int, default=-1,
                   choices=(-1, 0, 1),
                   help="override quality-aware frame weights "
                        "(-1 preset, 0 off, 1 on)")
    p.add_argument("--pyramid-dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="override agg.pyramid_dtype")
    p.add_argument("--shading-dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="override agg.shading_dtype")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p


def configure(args) -> C.Config:
    """The preset with the CLI's overrides, as the JAX CLI applies them."""
    cfg = preset_config(args)
    cfg = C.apply_blur_overrides(cfg, args.blur_mode, args.frame_weight)
    pr = cfg.probe
    if args.prune_iter is not None:
        pr = dataclasses.replace(pr, prune_iter=args.prune_iter)
    if args.prune_thresh is not None:
        pr = dataclasses.replace(pr, prune_thresh=args.prune_thresh)
    cfg = cfg.replace(probe=pr)
    if args.lr_decay_iters is not None:
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, lr_decay_iters=args.lr_decay_iters))
    if args.pyramid_dtype is not None:
        cfg = cfg.replace(agg=dataclasses.replace(
            cfg.agg, pyramid_dtype=args.pyramid_dtype))
    if args.shading_dtype is not None:
        cfg = cfg.replace(agg=dataclasses.replace(
            cfg.agg, shading_dtype=args.shading_dtype))
    if args.num_points is not None:
        cfg = cfg.replace(points=dataclasses.replace(
            cfg.points, num_points=args.num_points))
    return cfg


def init_mvs(cfg: C.Config, seed: int, device, use_mvsnet: bool = True,
             use_probnet: bool = False) -> point_gen.MvsPointsParams:
    """The MVS networks' initial parameters on `device` (the pretrained
    MVSNet, where --mvs-ckpt is given, replaces `mvsnet` after)."""
    gen = torch.Generator().manual_seed(seed)
    return point_gen.init(gen, cfg.points.feature_dim, use_mvsnet=use_mvsnet,
                          use_probnet=use_probnet, device=device)


def load_mvsnet(args, mvs_params, device) -> point_gen.MvsPointsParams:
    """mvs_params with --mvs-ckpt's MVSNet in place of `mvsnet`, where the
    flag is given."""
    if not args.mvs_ckpt:
        return mvs_params
    sd = torch_import.load_torch_state_dict(args.mvs_ckpt)
    return mvs_params._replace(mvsnet=torch_import.import_mvsnet(sd, device))


def group_views(dataset, group) -> Tuple[np.ndarray, np.ndarray]:
    """(images [3, H, W, 3], w2cs [3, 4, 4] float32) of a view triplet, its
    entries positions in the training list."""
    if hasattr(dataset, "train_id_list"):       # ScanNet
        ids = [dataset.train_id_list[i] for i in group]
        imgs = [dataset.image(v) for v in ids]
        c2ws = [dataset._pose(v) for v in ids]
    else:
        imgs = [dataset.train_image(int(i)) for i in group]
        c2ws = [dataset.c2w(int(i), dataset.train_meta) for i in group]
    return (np.stack(imgs),
            np.stack([np.linalg.inv(c) for c in c2ws]).astype(np.float32))


def mvs_bootstrap(args, dataset, cfg: C.Config, device
                  ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Mode 0 (gen_points_filter_embeddings, run/train_ft.py:60-197):
    MVSNet depth per view triplet (--mvs-ckpt's weights, else init_mvs's),
    the cross-triplet filter, the alpha mattes' visual hull where the
    scene has them, the voxel downsample at --vox-res, and each point's
    embedding, colour, direction and confidence (train/bootstrap)."""
    mvs_params = load_mvsnet(args, init_mvs(cfg, args.seed, device), device)
    groups = bootstrap.groups_from_dataset(dataset,
                                           max_groups=args.max_groups)
    views = [group_views(dataset, g) for g in groups]
    alphas = alpha_w2cs = None
    if hasattr(dataset, "train_alpha"):
        vids = sorted({int(i) for g in groups for i in g})
        alphas = np.stack([dataset.train_alpha(i) for i in vids])
        alpha_w2cs = np.stack([np.linalg.inv(
            dataset.c2w(i, dataset.train_meta)) for i in vids]
        ).astype(np.float32)
    return bootstrap.bootstrap_from_groups(
        mvs_params, [v[0] for v in views], dataset.intrinsic,
        [v[1] for v in views], cfg.render.near_plane, cfg.render.far_plane,
        cfg, conf_thresh=args.mvs_conf_thresh, vox_res=args.vox_res,
        num_depths=args.mvs_num_depths, alphas=alphas,
        alpha_w2cs=alpha_w2cs, device=device)


def bootstrap_points(args, dataset, cfg: C.Config
                     ) -> Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]:
    """The initial cloud (run/train_ft.py:679-778): (xyz [M, 3], attrs).
    Mode 0 is mvs_bootstrap on --device, with attrs, not cut.  Modes 1 and
    2 (the PLY mesh, every frame's sensor depth) give attrs None, their
    cloud voxel-downsampled at --vox-res (the point closest to each
    voxel's centroid), then cut to --bootstrap-cap (default num_points)
    by a seeded choice."""
    if args.load_points == 0:
        return mvs_bootstrap(args, dataset, cfg, resolve(args.device))
    if args.load_points == 1:
        xyz = dataset.load_init_points()
    else:
        xyz = dataset.load_init_depth_points()
    if args.vox_res > 0:
        xyz, _ = voxel_downsample_closest(xyz, args.vox_res)
    cap = args.bootstrap_cap or cfg.points.num_points
    if len(xyz) > cap:
        keep = np.random.default_rng(args.seed).choice(
            len(xyz), cap, replace=False)
        xyz = xyz[keep]
    return xyz, None


def init_params(cfg: C.Config, seed: int, device) -> Dict:
    """The network's initial parameters on `device`."""
    return renderer.init_params(cfg, seed=seed, device=device)


def init_embedding(n: int, cfg: C.Config, seed: int) -> np.ndarray:
    """Initial point embeddings [n, feature_dim]: normal * 0.1 (the
    reference's 'rand' feature init) from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n, cfg.points.feature_dim), generator=gen)
            * 0.1).numpy()


def step_noise(generator: torch.Generator, step: int, frames: int,
               rays: int, depth: int, device) -> torch.Tensor:
    """The candidate noise of training step `step`: [frames, rays, depth]
    uniform in [0, 1), drawn from `generator` (the JAX CLI draws each
    frame's from jax.random.fold_in(key, step), split per frame)."""
    return torch.rand((frames, rays, depth), generator=generator,
                      device=device)


def evaluate(params, points, grid, test_ds, cfg: C.Config,
             vis: Visualizer, step: int, num_frames: int, device) -> float:
    """Render `num_frames` test frames spread over the split whole
    (serve.render_full_frame), save them as PNGs and log their mean PSNR
    (the JAX CLI's `evaluate`)."""
    psnrs = []
    stride = max(len(test_ds) // max(num_frames, 1), 1)
    for fi in list(range(0, len(test_ds), stride))[:num_frames]:
        img = serve.render_full_frame(params, points, grid,
                                      test_ds.get_batch(fi), cfg,
                                      device=device)
        gt = test_ds.image(test_ds.id_list[fi])
        psnrs.append(M.psnr(img, gt))
        vis.save_image(img, step, f"test{fi:03d}-coarse_raycolor")
    mean_psnr = float(np.mean(psnrs))
    vis.log(f"eval step {step}: PSNR {mean_psnr:.3f} over {len(psnrs)} "
            f"frames")
    vis.add_scalar(step, "eval_psnr", mean_psnr)
    return mean_psnr


def train_ff(args, cfg: C.Config, train_ds, vis: Visualizer, ckpt_dir: str,
             device) -> step_ff.FFTrainState:
    """Feed-forward training (the JAX CLI's train_ff; reference
    mvs_points_volumetric_model.py:49-152): each step picks a random view
    triplet, regenerates its cloud through the MVS networks and trains
    them with the renderer on a ray batch of the triplet's first view
    (train/step_ff).  Without --mvs-ckpt the depth is the learned ProbNet
    volume's (conf threshold 0); with it, the pretrained MVSNet's at
    --mvs-conf-thresh.  Prints every --print-freq steps, saves
    ff_{step:08d}.npz every --save-freq steps and at the end; returns the
    state."""
    rng = np.random.default_rng(args.seed)
    learned = args.mvs_ckpt is None
    mvs_params = load_mvsnet(args, init_mvs(
        cfg, args.seed, device, use_mvsnet=not learned,
        use_probnet=learned), device)
    ffs = step_ff.create_ff_state(init_params(cfg, args.seed + 1, device),
                                  mvs_params, cfg, device=device)
    # the grid's geometry pinned to the querier's ranges: the cloud moves
    # every step, the tables keep their shapes
    r = np.asarray(cfg.querier.ranges, np.float32)
    geom = VG.compute_grid_geometry(np.stack([r[:3], r[3:]]),
                                    np.ones(2, bool), cfg.querier,
                                    device=device)
    groups = bootstrap.groups_from_dataset(train_ds,
                                           max_groups=args.max_groups)
    group_cache: Dict[int, Dict[str, torch.Tensor]] = {}

    def group_arrays(gi):
        if gi not in group_cache:
            images, w2cs = group_views(train_ds, groups[gi])
            group_cache[gi] = device_batch(
                {"images": images, "w2cs": w2cs,
                 "intrinsic": train_ds.intrinsic}, device)
        return group_cache[gi]

    max_steps = args.max_steps or cfg.optim.maximum_step
    vis.log(f"feed-forward training: {max_steps} steps over "
            f"{len(groups)} view groups "
            f"({'ProbNet' if learned else 'MVSNet'} depth)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    R, Z = cfg.sampling.rays_per_batch, cfg.querier.z_depth_dim
    t0 = time.time()
    step = ffs.step
    while step < max_steps:
        gi = int(rng.integers(len(groups)))
        # a position in train_id_list read as an index into id_list, as
        # in JAX (the blur-list quirk, ROADMAP Queue 3)
        b = train_ds.get_batch(int(groups[gi][0]), rng)
        ray_batch = device_batch({k: b[k] for k in step_ff.RAY_KEYS
                                  if k in b}, device)
        ffs, items = step_ff.train_step_ff(
            ffs, group_arrays(gi), ray_batch, geom, cfg,
            step_noise(gen, step, 1, R, Z, device)[0],
            num_depths=args.mvs_num_depths, learned=learned,
            conf_thresh=0.0 if learned else args.mvs_conf_thresh)
        step = ffs.step
        if step % args.print_freq == 0:
            vis.accumulate_losses({k: float(v) for k, v in items.items()
                                   if k.startswith("loss")})
            sps = step / max(time.time() - t0, 1e-9)
            vis.print_losses(step, extra=f"steps/s={sps:.2f} "
                             f"pts={int(items['num_points'])}")
        if (args.save_freq > 0 and step % args.save_freq == 0) \
                or step >= max_steps:
            step_ff.save_ff_checkpoint(ckpt_dir, ffs)
    vis.log(f"done: {max_steps} feed-forward steps")
    return ffs


def main(argv=None) -> Union[state_mod.TrainState, step_ff.FFTrainState]:
    """Train one scene; returns the final TrainState (the FFTrainState
    with --train-mode ff)."""
    args = build_argparser().parse_args(argv)
    dev = resolve(args.device)
    cfg = configure(args)
    name = args.name or cfg.name
    vis = Visualizer(args.checkpoints_dir, name)
    ckpt_dir = os.path.join(args.checkpoints_dir, name, "ckpt")
    # run-config snapshot: cli/test.py restores the eval settings from it
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "run_config.json"), "w") as f:
        json.dump({
            "preset": args.preset,
            "pyramid_dtype": cfg.agg.pyramid_dtype,
            "shading_dtype": cfg.agg.shading_dtype,
            "blur_mode": args.blur_mode,
            "num_points": cfg.points.num_points,
            "seed": args.seed,
        }, f, indent=1)

    scene = scene_class(args.preset)
    train_ds = scene(args.data_root, args.scan, cfg, "train")
    test_ds = scene(args.data_root, args.scan, cfg, "test")
    rng = np.random.default_rng(args.seed)
    if args.train_mode == "ff":
        return train_ff(args, cfg, train_ds, vis, ckpt_dir, dev)

    vis.log(f"bootstrapping points (mode {args.load_points})...")
    xyz, attrs = bootstrap_points(args, train_ds, cfg)
    vis.log(f"init cloud: {len(xyz)} points")
    if args.drop_box is not None:
        lo, hi = np.asarray(args.drop_box[:3]), np.asarray(args.drop_box[3:])
        inside = np.all((xyz >= lo) & (xyz <= hi), axis=1)
        xyz = xyz[~inside]
        if attrs is not None:
            attrs = {k: v[~inside] for k, v in attrs.items()}
        vis.log(f"drop-box removed {int(inside.sum())} points "
                f"(hole for lifecycle runs; {len(xyz)} remain)")
    if attrs is not None and len(xyz) > cfg.points.num_points:
        # mode 0's cloud is cut here, by the run's own generator (JAX
        # cli/train.py:376-379)
        keep = rng.choice(len(xyz), cfg.points.num_points, replace=False)
        xyz = xyz[keep]
        attrs = {k: v[keep] for k, v in attrs.items()}
    if attrs is None:
        attrs = {"embedding": init_embedding(len(xyz), cfg, args.seed)}
    points = npts.init_from_arrays(xyz, cfg.points, device=dev, **attrs)
    grid = VG.grid_of(points.xyz, points.mask, cfg.querier)
    if grid.num_nodes is not None and \
            int(grid.num_nodes) >= cfg.querier.max_nodes:
        raise ValueError(
            f"supervoxel node table full ({int(grid.num_nodes)} >= "
            f"max_nodes={cfg.querier.max_nodes}): raise QuerierConfig."
            f"max_nodes or disable supervoxel")

    ts = state_mod.create_train_state(init_params(cfg, args.seed, dev),
                                      points, cfg, device=dev)
    best_psnr = 0.0
    if args.resume:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir)
        if latest:
            ts, best_psnr = ckpt_mod.load_checkpoint(latest, cfg, device=dev)
            grid = VG.grid_of(ts.points.xyz, ts.points.mask, cfg.querier)
            vis.log(f"resumed from {latest} at step {int(ts.step)}")

    kernels = torch.as_tensor(blur_mod.generate_kernel_bank(cfg.blur),
                              device=dev)
    tracker = lifecycle.RayMissTracker()
    max_steps = args.max_steps or cfg.optim.maximum_step
    prob_freq = args.prob_freq or cfg.probe.prob_freq
    # the tracker's per-step miss-loss read is a device sync; it pays only
    # when probing picks frames by miss-loss rank (prob_top = 1) and does
    # not visit every training frame anyway
    use_tracker = (prob_freq > 0 and cfg.probe.prob_top == 1
                   and (args.prob_frames or 0) < len(train_ds))

    # cached steps reuse the views' pyramid stage maps; the CNN trains,
    # and the cache is refilled, in the schedule's bursts
    pyr_cache = None
    if cfg.optim.pyramid_cache and cfg.agg.use_nearest > 0:
        pyr_cache = pc_mod.PyramidCache(cfg)
        vis.log(f"pyramid cache on: burst {cfg.optim.pyramid_burst_steps}/"
                f"{cfg.optim.pyramid_cycle_steps} steps")

    # device view bank: each training view's RGB goes to the device once,
    # and a step's nearest-view stack is assembled there
    view_bank: Dict[int, torch.Tensor] = {}

    def device_views(b):
        nvids = b.get("nearest_vids")
        if nvids is None or "images_nearest" not in b:
            return
        stack = []
        for i, v in enumerate(nvids):
            v = int(v)
            if v not in view_bank:
                view_bank[v] = torch.as_tensor(b["images_nearest"][i],
                                               device=dev)
            stack.append(view_bank[v])
        b["images_nearest"] = torch.stack(stack)

    def staged_features(b):
        """Cached (images, stages) of one frame's nearest-view stack."""
        nvids = b.get("nearest_vids")
        if pyr_cache is None or nvids is None:
            return None
        return (b["images_nearest"],
                pyr_cache.get_stack(ts.params, b["images_nearest"], nvids))

    native_pipe = None

    def next_batch(step_seed):
        fi = int(rng.integers(len(train_ds)))
        if native_pipe is None:
            return fi, train_ds.get_batch(fi, rng)
        # the native sampler draws the pixels, gathers the ground truth
        # and makes the ray directions; get_batch adds the pose, the
        # nearest views and the frame weight
        vid = train_ds.id_list[fi]
        s = cfg.sampling
        native_pipe.submit(train_ds.image(vid), s.edge_filter,
                           s.dilation_patch_num, s.dilation_patch_size,
                           s.dilation_min, s.dilation_max,
                           train_ds.intrinsic, train_ds._pose(vid)[:3, :3],
                           step_seed)
        _, xy, rgb, dirs = native_pipe.pop()
        b = train_ds.get_batch(fi, rng, pixelcoords=xy.reshape(
            s.random_sample_size, s.random_sample_size, 2))
        b["raydir"], b["gt_image"] = dirs, rgb
        return fi, b

    def log_box_live(s):
        """Live points inside the drop box after a lifecycle event."""
        if args.drop_box is None:
            return
        xyz_h = ts.points.xyz.cpu().numpy()
        mask_h = ts.points.mask.cpu().numpy()
        lo, hi = np.asarray(args.drop_box[:3]), np.asarray(args.drop_box[3:])
        n_in = int((mask_h & np.all((xyz_h >= lo) & (xyz_h <= hi),
                                    axis=1)).sum())
        vis.add_scalar(s, "box_live", n_in)
        vis.log(f"  drop-box live points: {n_in}")

    vis.log(f"training {name}: {max_steps} steps, "
            f"{cfg.sampling.rays_per_batch} rays/step, "
            f"{int(ts.points.num_live)} live points")
    if args.native_prefetch > 0:
        if cfg.sampling.random_sample == "dilated":
            native_pipe = native_sampler.PrefetchPipeline(
                args.native_prefetch)
            vis.log(f"native prefetch on ({args.native_prefetch} workers)")
        else:
            vis.log(f"native prefetch off: the native sampler draws "
                    f"dilated batches, the preset samples "
                    f"'{cfg.sampling.random_sample}'")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    R, Z = cfg.sampling.rays_per_batch, cfg.querier.z_depth_dim
    F = args.frames_per_step
    t_start = time.time()
    step = int(ts.step)
    was_burst = True
    while step < max_steps:
        burst = pyr_cache is None or pc_mod.in_burst(step, cfg.optim)
        if pyr_cache is not None and burst and not was_burst:
            pyr_cache.invalidate()      # the CNN's parameters will change
        was_burst = burst
        use_cache = pyr_cache is not None and not burst
        noise = step_noise(gen, step, F, R, Z, dev)
        if F > 1:
            frames, staged_list = [], []
            for _ in range(F):
                fi, b = next_batch(step)
                device_views(b)
                if use_cache:
                    staged_list.append(staged_features(b))
                frames.append(step_mod.device_batch(b))
            batches = device_batch(step_mod.stack_batches(frames), dev)
            staged = None
            if use_cache and all(s is not None for s in staged_list):
                staged = (torch.stack([s[0] for s in staged_list]),
                          tuple(torch.stack([s[1][j] for s in staged_list])
                                for j in range(3)))
            ts, items = step_mod.train_step_multi(
                ts, grid, batches, kernels, cfg, noise=noise,
                img_feat_staged=staged)
        else:
            fi, batch = next_batch(step)
            device_views(batch)
            staged = staged_features(batch) if use_cache else None
            batch = step_mod.maybe_add_bg_ray(batch, ts.points, cfg)
            ts, items = step_mod.train_step(
                ts, grid, device_batch(batch, dev), kernels, cfg,
                noise=noise[0], img_feat_staged=staged)
        step += 1

        if use_tracker and "loss_ray_miss_coarse_raycolor" in items:
            tracker.update(fi, float(items["loss_ray_miss_coarse_raycolor"]))

        if step % args.print_freq == 0:
            vis.accumulate_losses({k: float(v) for k, v in items.items()
                                   if k.startswith("loss")})
            sps = step / max(time.time() - t_start, 1e-9)
            vis.print_losses(step, extra=f"steps/s={sps:.2f}")

        if args.test_freq > 0 and step % args.test_freq == 0:
            mean_psnr = evaluate(ts.params, ts.points, grid, test_ds, cfg,
                                 vis, step, args.test_num, dev)
            if mean_psnr > best_psnr:
                best_psnr = mean_psnr
                ckpt_mod.save_checkpoint(ckpt_dir, ts, best_psnr)

        if args.save_freq > 0 and step % args.save_freq == 0:
            ckpt_mod.save_checkpoint(ckpt_dir, ts, best_psnr)

        if (cfg.probe.prune_iter > 0 and step % cfg.probe.prune_iter == 0
                and step <= cfg.probe.prune_max_iter and step < max_steps):
            # conf-threshold prune (run/train_ft.py:868-872); the
            # optimizers carry on, as in the reference
            before = int(ts.points.num_live)
            pts, grid = lifecycle.prune_and_rebuild(ts.points, cfg)
            ts = dataclasses.replace(ts, points=pts)
            vis.log(f"pruned {before - pts.num_live} points at step {step} "
                    f"(live: {pts.num_live})")
            vis.add_scalar(step, "pruned_points", before - pts.num_live)
            vis.add_scalar(step, "num_points", pts.num_live)
            log_box_live(step)

        if prob_freq > 0 and step % prob_freq == 0 and step < max_steps:
            # per-tier probe schedule (run/train_ft.py:878-903): the tier
            # from the step count; no probing past the last tier
            tier = int(np.sum(np.asarray(cfg.probe.prob_tiers) < step))
            n_tiers = len(cfg.probe.prob_kernel_size) // 3
            top = tracker.top_ids()
            gate = (not use_tracker or len(top) > 0
                    or cfg.probe.prob_top != 1 or cfg.probe.far_thresh > 0)
            if tier < n_tiers and gate:
                qs = tuple(cfg.probe.prob_kernel_size[tier * 3:tier * 3 + 3])
                vis.log(f"probe-and-grow at step {step} "
                        f"(tier {tier}, query_size {qs})...")
                new_points, new_grid, n_added = lifecycle.probe_and_grow(
                    ts.params, ts.points, grid, train_ds, cfg,
                    tracker if use_tracker else None,
                    max_frames=args.prob_frames or None,
                    rng=rng, query_size_override=qs)
                if n_added > 0:
                    ts = state_mod.reset_optimizers(
                        dataclasses.replace(ts, points=new_points), cfg)
                    grid = new_grid
                    vis.log(f"grew {n_added} points "
                            f"(live: {ts.points.num_live})")
                    vis.add_scalar(step, "grown_points", n_added)
                    vis.add_scalar(step, "num_points", ts.points.num_live)
                    log_box_live(step)

    if native_pipe is not None:
        native_pipe.close()
    ckpt_mod.save_checkpoint(ckpt_dir, ts, best_psnr)
    vis.log(f"done: {max_steps} steps, best PSNR {best_psnr:.3f}")
    return ts


if __name__ == "__main__":
    main()
