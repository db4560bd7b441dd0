"""Quality-aware frame weights, offline (JAX: hybridneuralrendering_tpu/
data/frame_weights.py; reference raft/demo_content_aware_weights.py:78-226).

Each training frame's sharpness is the variance of its Laplacian edge map
inside a border; the next frame's edge map, warped into the current frame
by the optical flow, anchors a relative scale, so the per-pair scores chain
into absolute ones; a sliding window turns them into loss weights.  The
flow is pluggable (`flow_fn`, identity when None): flow/raft.make_flow_fn
gives RAFT's.  Host numpy throughout, as the port's data layer.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

LAPLACIAN = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)


def _mean_blur(img: np.ndarray, k: int = 5) -> np.ndarray:
    """k x k box mean with reflected borders (numpy's "reflect", OpenCV's
    BORDER_REFLECT_101), by summed-area table."""
    pad = k // 2
    padded = np.pad(img, pad, mode="reflect")
    c = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = img.shape
    s = (c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w])
    return s / (k * k)


def laplacian_edge(img_gray: np.ndarray, blur_func: str = "mean",
                   k_size: int = 5) -> np.ndarray:
    """The 4-neighbour Laplacian of the (box-blurred) grey frame, reflected
    at the border (the reference's detect_blurry)."""
    img = np.asarray(img_gray, np.float64)
    if blur_func == "mean":
        img = _mean_blur(img, k_size)
    padded = np.pad(img, 1, mode="reflect")
    return (padded[:-2, 1:-1] + padded[2:, 1:-1] + padded[1:-1, :-2]
            + padded[1:-1, 2:] - 4 * img)


def warp_by_flow(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Nearest-neighbour backward warp out(x) = img(x + flow(x)) with flow
    [H, W, 2] = (fx, fy); samples outside the frame are 0."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w]
    sx = np.rint(xs + flow[..., 0]).astype(int)
    sy = np.rint(ys + flow[..., 1]).astype(int)
    ok = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros_like(img)
    out[ok] = img[sy[ok], sx[ok]]
    return out


def blur_scores(frames_gray: Sequence[np.ndarray],
                flow_fn: Optional[Callable] = None, border: int = 20):
    """(scores_cur, scores_ref): per frame the edge variance of the frame
    and of the next frame warped onto it (the last frame is its own next),
    over the pixels inside `border` that the warp keeps."""
    scores_cur, scores_ref = [], []
    n = len(frames_gray)
    for i in range(n):
        cur = np.asarray(frames_gray[i], np.float64)
        ref = np.asarray(frames_gray[min(i + 1, n - 1)], np.float64)
        e1 = laplacian_edge(cur)
        e2 = laplacian_edge(ref)
        h, w = cur.shape
        mask1 = np.zeros((h, w))
        mask1[border:-border, border:-border] = 1
        mask2 = mask1.copy()
        if flow_fn is not None and i + 1 < n:
            flow = flow_fn(cur, ref)
            e2 = warp_by_flow(e2, flow)
            mask2 = warp_by_flow(mask2, flow)
        used = (mask1 * mask2) == 1
        scores_cur.append(e1[used].var())
        scores_ref.append(e2[used].var())
    return scores_cur, scores_ref


def chain_scores(scores_cur: Sequence[float],
                 scores_ref: Sequence[float]) -> np.ndarray:
    """Per-pair relative scales chained into absolute scores."""
    out = []
    scale = 1.0
    n = len(scores_cur)
    for i in range(n):
        out.append(scores_cur[i] * scale)
        if i == n - 1:
            continue
        scale = scores_ref[i] * scale / scores_cur[i + 1]
    return np.asarray(out)


def sliding_window_weights(scores_absolute: np.ndarray, window_size: int = 10,
                           step: int = 5) -> np.ndarray:
    """Scores over their window's mean, averaged over the overlapping
    windows of `window_size` frames every `step` frames."""
    n = len(scores_absolute)
    weight = np.zeros(n)
    count = np.zeros(n)
    begin = 0
    while True:
        end = begin + window_size
        last = end >= n
        end = min(end, n)
        bundle = scores_absolute[begin:end]
        weight[begin:end] += bundle / bundle.mean()
        count[begin:end] += 1
        if last:
            break
        begin += step
    return weight / count


def compute_frame_weights(frames_gray: Sequence[np.ndarray],
                          flow_fn: Optional[Callable] = None,
                          window_size: int = 10, step: int = 5,
                          border: int = 20) -> np.ndarray:
    """The loss weight [n] of each of the n training frames in order."""
    sc, sr = blur_scores(frames_gray, flow_fn, border)
    return sliding_window_weights(chain_scores(sc, sr), window_size, step)
