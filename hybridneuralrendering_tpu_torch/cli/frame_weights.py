"""Quality-aware frame-weight precompute CLI (JAX:
hybridneuralrendering_tpu/cli/frame_weights.py; reference
raft/demo_content_aware_weights.py).

Reads the training frames of a ScanNet scene (the train split: every 5th
frame), grey x 255, runs RAFT between consecutive frames (weights from a
reference-layout `--raft-ckpt`; identity flow without one), chains their
Laplacian blur scores and normalises them over a sliding window
(data/frame_weights.py), and writes
`<out>/frame_weights_step5/<scan>_frame_weight_step5.npy` (float32), the
file ScannetScene reads when `use_frame_weight` is on.  Runs on the card
unless `--device cpu` is given:

    python -m hybridneuralrendering_tpu_torch.cli.frame_weights \\
        --data-root <scans> --scan scene0241_01 --raft-ckpt raft-things.pth
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from hybridneuralrendering_tpu_torch import config as C
from hybridneuralrendering_tpu_torch.data import frame_weights as FW
from hybridneuralrendering_tpu_torch.data.scannet import ScannetScene
from hybridneuralrendering_tpu_torch.device import resolve


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--scan", default="scene0241_01")
    p.add_argument("--out", default=None,
                   help="output root (default: data-root)")
    p.add_argument("--raft-ckpt", default=None,
                   help="pretrained RAFT .pth; identity flow if omitted "
                        "(serviceable for small camera steps)")
    p.add_argument("--iters", type=int, default=12, help="RAFT iterations")
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--window-step", type=int, default=5)
    p.add_argument("--preset", default="scannet_full")
    p.add_argument("--device", default="cuda",
                   help="torch device RAFT runs on (default: the card)")
    return p


def main(argv=None) -> str:
    """Compute and write the weights; returns the .npy's path."""
    args = build_argparser().parse_args(argv)
    dev = resolve(args.device)
    cfg = C.PRESETS[args.preset](args.scan) if args.preset.startswith(
        "scannet") else C.PRESETS[args.preset]()
    # the weights are the loader's input: compute them without needing them
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                               use_frame_weight=False))
    ds = ScannetScene(args.data_root, args.scan, cfg, "train")
    frames = [(ds.image(vid).mean(-1) * 255.0).astype(np.float32)
              for vid in ds.train_id_list]
    print(f"{len(frames)} training frames (every 5th)")

    flow_fn = None
    if args.raft_ckpt:
        from hybridneuralrendering_tpu_torch.flow import raft as raft_mod
        from hybridneuralrendering_tpu_torch.io import torch_import as TI
        flow_fn = raft_mod.make_flow_fn(TI.load_raft(args.raft_ckpt, dev),
                                        iters=args.iters)
        print(f"RAFT weights imported from {args.raft_ckpt}")
    else:
        print("no --raft-ckpt: identity flow")

    weights = FW.compute_frame_weights(
        frames, flow_fn=flow_fn, window_size=args.window,
        step=args.window_step)

    out_dir = os.path.join(args.out or args.data_root, "frame_weights_step5")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{args.scan}_frame_weight_step5.npy")
    np.save(out_path, weights.astype(np.float32))
    print(f"wrote {out_path}: {weights.shape} "
          f"min={weights.min():.4f} max={weights.max():.4f}")
    return out_path


if __name__ == "__main__":
    main()
