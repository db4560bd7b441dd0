"""Run log and artefacts (JAX: hybridneuralrendering_tpu/utils/visualizer.py).

An append-only log.txt, accumulated loss means with their PSNR, a
`scalars.jsonl` stream, PNG dumps under `<out_dir>/<name>/images/` and a
video of them: the reference's layout.  PNGs go through io/png.py; the
video needs `imageio` (imported where it is used, as in the JAX package).
Point dumps (save_neural_points, whose only JAX caller is cli/edit) come
with the edit slice.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.io import png


def to8b(x) -> np.ndarray:
    """[0, 1] floats -> uint8, truncating as the JAX package does."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


class Visualizer:
    def __init__(self, out_dir: str, name: str = "run"):
        self.dir = os.path.join(out_dir, name)
        self.img_dir = os.path.join(self.dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.log_path = os.path.join(self.dir, "log.txt")
        self._acc: Dict[str, list] = defaultdict(list)

    def log(self, msg: str):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with open(self.log_path, "a") as f:
            f.write(f"[{stamp}] {msg}\n")
        print(msg, flush=True)

    # -- loss accumulation -------------------------------------------------

    def accumulate_losses(self, items: Dict[str, float]):
        for k, v in items.items():
            self._acc[k].append(float(v))

    def print_losses(self, step: int, extra: str = ""):
        parts = [f"step {step}"]
        for k, vals in sorted(self._acc.items()):
            mean = float(np.mean(vals))
            parts.append(f"{k}={mean:.6f}")
            self.add_scalar(step, k, mean)
            if k.endswith("coarse_raycolor"):
                psnr = -10 * np.log10(max(mean, 1e-10))
                parts.append(f"PSNR[{k}]={psnr:.3f}")
                self.add_scalar(step, f"PSNR[{k}]", psnr)
        if extra:
            parts.append(extra)
        self.log("  ".join(parts))
        self._acc.clear()

    def add_scalar(self, step: int, tag: str, value: float):
        """One JSON object per line in `scalars.jsonl`."""
        with open(os.path.join(self.dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"step": int(step), "tag": tag,
                                "value": float(value)}) + "\n")

    # -- artefacts ----------------------------------------------------------

    def save_image(self, img, step: int, name: str) -> str:
        path = os.path.join(self.img_dir, f"step-{step:04d}-{name}.png")
        png.write(path, to8b(img))
        return path

    def gen_video(self, pattern_dir: Optional[str] = None, fps: int = 20,
                  out_name: str = "video.mp4") -> Optional[str]:
        """The PNGs of `pattern_dir` (default the images dir), in name
        order, as a video beside them: mp4 where imageio can write one
        (ffmpeg), else a GIF of 1000 / fps ms a frame, as JAX's gen_video.
        Returns its path, or None without frames.  Raises
        ModuleNotFoundError where imageio is not installed."""
        import imageio.v2 as imageio
        d = pattern_dir or self.img_dir
        frames = sorted(f for f in os.listdir(d) if f.endswith(".png"))
        if not frames:
            return None
        path = os.path.join(self.dir, out_name)
        try:
            with imageio.get_writer(path, fps=fps) as w:
                for f in frames:
                    w.append_data(png.read(os.path.join(d, f)))
            return path
        except Exception:
            path = os.path.splitext(path)[0] + ".gif"
            with imageio.get_writer(path, duration=1000.0 / fps) as w:
                for f in frames:
                    w.append_data(png.read(os.path.join(d, f)))
            return path
