"""RAFT optical flow for the quality-aware frame weights
(JAX: hybridneuralrendering_tpu/flow/raft.py; reference raft/core/{raft,
extractor,corr,update}.py).

The networks are nn.Modules named as the reference's, so a reference
checkpoint (`raft-things.pth`, `module.`-prefixed) loads with
load_state_dict once the prefix is stripped (io/torch_import.load_raft):
`fnet` (BasicEncoder, instance norm without affine), `cnet` (BasicEncoder,
batch norm with running statistics, used in eval mode) and `update_block`
(motion encoder, SepConvGRU, flow head, upsampling mask).  The modules work
on NCHW maps; the correlation functions take the JAX package's layouts:
the all-pairs volume of one pair is one [H*W, C] x [C, H*W] product
(`corr_pyramid`), sampled bilinearly with zero padding around the current
flow target at every level (`corr_lookup`).  Float32 convolutions run
without TF32 (device.no_tf32).  RAFT holds no TPU kernel: it runs on
PyTorch's convolutions and matmul, offline, once a scene
(data/frame_weights.py).
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hybridneuralrendering_tpu_torch.device import no_tf32, resolve

CORR_LEVELS = 4
CORR_RADIUS = 4
HDIM = 128
CDIM = 128


def _norm(kind: str, ch: int) -> nn.Module:
    if kind == "batch":
        return nn.BatchNorm2d(ch)
    if kind == "instance":
        return nn.InstanceNorm2d(ch)
    raise ValueError(f"norm {kind!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm and ReLU; a strided 1x1 conv + norm on the
    skip path where the block downsamples (extractor.py:6-60)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                               stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU()
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            # registered twice, as in the reference: its state_dict keys
            # are both norm3.* and downsample.1.*
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """[B, 3, H, W] -> [B, output_dim, H/8, W/8] (extractor.py:118-190)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch"):
        super().__init__()
        self.norm1 = _norm(norm_fn, 64)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.relu1 = nn.ReLU()
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """A GRU of (1, 5) convolutions, then one of (5, 1)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    @staticmethod
    def _half(h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._half(h, x, self.convz1, self.convr1, self.convq1)
        return self._half(h, x, self.convz2, self.convr2, self.convq2)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """(net, inp, corr, flow) -> (net, upsampling mask, flow delta)
    (update.py:116-136)."""

    def __init__(self, hidden_dim: int = HDIM):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class RAFT(nn.Module):
    """The reference's RAFT (small=False): its parameter names, its
    layers; run it with estimate_flow in eval mode."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HDIM + CDIM, "batch")
        self.update_block = BasicUpdateBlock(HDIM)


def init(seed: int = 0, device="cuda") -> RAFT:
    """A RAFT in eval mode with seeded weights, drawn as the JAX package's
    raft.init draws them: convolutions normal with std sqrt(2 / fan_out),
    zero biases, batch norms at the identity."""
    gen = torch.Generator().manual_seed(seed)
    model = RAFT()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * math.sqrt(2.0 / fan_out))
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model.eval().to(resolve(device))


# ---------------------------------------------------------------- correlation

def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = CORR_LEVELS) -> List[torch.Tensor]:
    """All-pairs correlation of fmap1, fmap2 [H, W, C], averaged in 2x2
    windows of fmap2's positions from level to level: level i is
    [H*W, H/2^i, W/2^i], each size floored, and an axis of size 1 is left
    as it is."""
    H, W, C = fmap1.shape
    corr = (fmap1.reshape(H * W, C) @ fmap2.reshape(H * W, C).T) / math.sqrt(C)
    corr = corr.reshape(H * W, H, W)
    pyr = [corr]
    for _ in range(num_levels - 1):
        h = max(corr.shape[1] // 2, 1)
        w = max(corr.shape[2] // 2, 1)
        if corr.shape[1] >= 2:
            corr = corr[:, :h * 2].reshape(H * W, h, 2,
                                           corr.shape[2]).mean(2)
        if corr.shape[2] >= 2:
            corr = corr[:, :, :w * 2].reshape(H * W, h, w, 2).mean(3)
        pyr.append(corr)
    return pyr


def bilinear_hw(vol: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """vol [N, h, w] sampled at xy [N, K, 2] (x, y) of its own slice,
    zero outside; the four taps summed in the JAX package's order."""
    N, h, w = vol.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    wx, wy = x - x0, y - y0
    n_ix = torch.arange(N, device=vol.device)[:, None]

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return vol[n_ix, yy.clamp(0, h - 1), xx.clamp(0, w - 1)] * ok

    return (tap(y0, x0) * (1 - wx) * (1 - wy)
            + tap(y0, x0 + 1) * wx * (1 - wy)
            + tap(y0 + 1, x0) * (1 - wx) * wy
            + tap(y0 + 1, x0 + 1) * wx * wy)


def corr_lookup(pyr: List[torch.Tensor], coords: torch.Tensor,
                radius: int = CORR_RADIUS) -> torch.Tensor:
    """The (2r+1)^2 window around coords [H, W, 2] (level-0 positions) at
    every level -> [H, W, levels * (2r+1)^2].  Window channel (i, j)
    moves x by d_i and y by d_j: the reference stacks meshgrid(dy, dx) and
    adds it to (x, y), and imported motion-encoder weights expect that
    order."""
    H, W, _ = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"),
                        dim=-1).reshape(-1, 2)
    out = [bilinear_hw(vol, coords.reshape(H * W, 1, 2) / (2 ** i)
                       + delta[None])
           for i, vol in enumerate(pyr)]
    return torch.cat(out, dim=-1).reshape(H, W, -1)


def upsample_flow_convex(flow: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling (raft.py:73-86): flow [1, h, w, 2] and mask
    [1, h, w, 576] -> [1, 8h, 8w, 2], each fine flow a softmax-weighted
    mix of 8 x the coarse flow's 3x3 neighbourhood (zero outside)."""
    _, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(h, w, 9, 8, 8), dim=2)
    pads = F.pad(8.0 * flow[0], (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pads[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dim=2)                                # [h, w, 9, 2]
    up = torch.einsum("hwkab,hwkc->hwabc", m, neigh)         # [h, w, 8, 8, 2]
    return up.permute(0, 2, 1, 3, 4).reshape(1, 8 * h, 8 * w, 2)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 0, 1)[None]


def _hwc(x: torch.Tensor) -> torch.Tensor:
    return x[0].permute(1, 2, 0)


@torch.inference_mode()
def estimate_flow(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                  iters: int = 12) -> torch.Tensor:
    """Flow [H, W, 2] from image1 to image2, [H, W, 3] in [0, 255] with H
    and W multiples of 8, after `iters` refinements (raft.py:88-150)."""
    if model.training:
        raise ValueError("estimate_flow needs the model in eval mode "
                         "(the batch norms' running statistics)")
    H, W, _ = image1.shape
    x1 = _nchw(2 * (image1 / 255.0) - 1.0)
    x2 = _nchw(2 * (image2 / 255.0) - 1.0)
    with no_tf32():
        pyr = corr_pyramid(_hwc(model.fnet(x1)), _hwc(model.fnet(x2)))
        net, inp = torch.split(model.cnet(x1), [HDIM, CDIM], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)
        h, w = H // 8, W // 8
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=image1.device),
            torch.arange(w, dtype=torch.float32, device=image1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1)              # [h, w, 2]
        coords1, mask = coords0, None
        for _ in range(iters):
            corr = corr_lookup(pyr, coords1)
            net, mask, delta = model.update_block(
                net, inp, _nchw(corr), _nchw(coords1 - coords0))
            coords1 = coords1 + _hwc(delta)
        up = upsample_flow_convex((coords1 - coords0)[None],
                                  mask.permute(0, 2, 3, 1))
    return up[0]


def make_flow_fn(model: RAFT, iters: int = 12
                 ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """data/frame_weights' flow_fn: two grey frames [H, W] in [0, 255] ->
    flow [H, W, 2] (numpy float32), computed on the model's device with the
    frames padded by their edge to multiples of 8."""
    dev = next(model.parameters()).device

    def flow_fn(img1_gray, img2_gray):
        H, W = img1_gray.shape
        H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8

        def prep(g):
            rgb = np.repeat(np.asarray(g, np.float32)[..., None], 3, -1)
            return torch.as_tensor(
                np.pad(rgb, ((0, H8 - H), (0, W8 - W), (0, 0)), mode="edge"),
                device=dev)

        out = estimate_flow(model, prep(img1_gray), prep(img2_gray), iters)
        return out.cpu().numpy()[:H, :W]

    return flow_fn
