"""Image quality metrics: PSNR, SSIM, RMSE and LPIPS where the `lpips`
package is installed (JAX: hybridneuralrendering_tpu/utils/metrics.py).

On tensors, on the images' device, in float64 as the JAX package's numpy
computes them; numpy arrays are taken as CPU tensors.  SSIM is the JAX
package's: skimage's `structural_similarity` with its defaults, an 11 x 11
uniform window applied as two 'valid' passes, sample covariance, the
per-channel maps averaged.  The results agree with the JAX package's to
float64 summation order (tests/test_torch_port_data.py states the limit).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _f64(x, device=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return t.to(device or t.device, torch.float64)


def _pair(img, ref):
    img = _f64(img)
    return img, _f64(ref, img.device)


def psnr(img, ref, max_val: float = 1.0) -> float:
    img, ref = _pair(img, ref)
    mse = float(torch.mean((img - ref) ** 2))
    if mse <= 1e-12:
        return 99.0
    return 10.0 * math.log10(max_val ** 2 / mse)


def rmse(img, ref) -> float:
    img, ref = _pair(img, ref)
    return float(torch.sqrt(torch.mean((img - ref) ** 2)))


def _filter2d_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' correlation along the first two axes."""
    n = k.shape[0]
    img = img.unfold(0, n, 1) @ k
    return img.unfold(1, n, 1) @ k


def ssim(img, ref, max_val: float = 1.0, k1: float = 0.01, k2: float = 0.03,
         win_size: int = 11) -> float:
    """Mean SSIM of the reference protocol (`compare_ssim(gt, img, 11,
    multichannel=True)`): uniform win_size x win_size window, sample
    covariance, per-channel maps averaged over the valid region.
    `max_val` is skimage's data_range."""
    img, ref = _pair(img, ref)
    if img.ndim == 2:
        img, ref = img[..., None], ref[..., None]
    k = torch.full((win_size,), 1.0 / win_size, dtype=torch.float64,
                   device=img.device)
    npix = win_size * win_size
    cov_norm = npix / (npix - 1.0)
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    vals = []
    for c in range(img.shape[-1]):
        x, y = img[..., c], ref[..., c]
        mx = _filter2d_sep(x, k)
        my = _filter2d_sep(y, k)
        vx = cov_norm * (_filter2d_sep(x * x, k) - mx ** 2)
        vy = cov_norm * (_filter2d_sep(y * y, k) - my ** 2)
        cov = cov_norm * (_filter2d_sep(x * y, k) - mx * my)
        s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
            (mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(torch.stack(vals).mean())


def lpips(img, ref, net: str = "alex") -> Optional[float]:
    """None where the `lpips` package is missing, as in the JAX package.
    Scoring with the package (and its backbone weights) is not ported
    yet: where it is installed this raises rather than report nothing."""
    try:
        import lpips as _lpips_pkg  # noqa: F401
    except ImportError:
        return None
    raise NotImplementedError("LPIPS through the lpips package is not "
                              "ported yet (ROADMAP item 5)")


def report_metrics(preds: Sequence, gts: Sequence,
                   with_lpips: bool = True) -> Dict[str, float]:
    """Means over rendered / ground-truth image pairs (the reference's
    run/evaluate.py protocol).  An LPIPS that is None (no `lpips`
    package) leaves its key out, as in the JAX package."""
    out: Dict[str, list] = {"psnr": [], "ssim": [], "rmse": []}
    if with_lpips:
        out["lpips"] = []
        out["vgglpips"] = []
    for p, g in zip(preds, gts):
        out["psnr"].append(psnr(p, g))
        out["ssim"].append(ssim(p, g))
        out["rmse"].append(rmse(p, g))
        if with_lpips:
            l_a = lpips(p, g, "alex")
            l_v = lpips(p, g, "vgg")
            if l_a is not None:
                out["lpips"].append(l_a)
            if l_v is not None:
                out["vgglpips"].append(l_v)
    return {k: float(np.mean(v)) for k, v in out.items() if len(v)}
