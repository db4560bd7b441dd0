"""The port's MVS modules (hybridneuralrendering_tpu_torch/mvs/*) and its
MVSNet importer against the JAX package, on the CPU.

Inputs are numpy arrays from seeds at the sizes of tests/test_mvs.py
(24-48 x 32-64 images, D = 8-16, 3 views); weights are seeded numpy trees
of JAX's shapes (numpy_mvs_params) carried across with
io/from_jax.mvs_params_from_numpy.  JAX runs jitted where its op-by-op
mode would be slow, as its own tests do.  Tolerances:

- gathers, masks and integer results: equal;
- float results: rtol 1e-5, atol 1e-5 * max|JAX| (the two frameworks sum
  convolutions and products in another order);
- a mask that follows a threshold (conf > thresh, dist < 1 px, rel < 1%,
  alpha > 0.1, the in-bounds tests) must be equal: each test asserts that
  no JAX value lies within THRESH_MARGIN of its threshold, so float32
  rounding cannot flip one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hybridneuralrendering_tpu.io import torch_import as JTI
from hybridneuralrendering_tpu.mvs import features as JF
from hybridneuralrendering_tpu.mvs import filter as JGF
from hybridneuralrendering_tpu.mvs import mvsnet as JM
from hybridneuralrendering_tpu.mvs import point_gen as JP
from hybridneuralrendering_tpu.mvs import warp as JW
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.io import torch_import as TTI
from hybridneuralrendering_tpu_torch.mvs import features as TF
from hybridneuralrendering_tpu_torch.mvs import filter as TGF
from hybridneuralrendering_tpu_torch.mvs import mvsnet as TM
from hybridneuralrendering_tpu_torch.mvs import point_gen as TP
from hybridneuralrendering_tpu_torch.mvs import warp as TW
from hybridneuralrendering_tpu_torch.train import state as TS
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    jax_tree, mvsnet_state_dict, n, numpy_mvs_params, one_torch_thread,
    save_mvsnet_ckpt, t)

CPU = "cpu"
THRESH_MARGIN = 1e-4


def close(got, want, rtol=1e-5):
    """Equal shapes and non-finite entries; the finite ones within rtol
    and rtol * max|want| (over the finite entries)."""
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * max(scale, 1e-30))


def away(values, thresh, margin=THRESH_MARGIN):
    """No value within `margin` of `thresh`, relative to a nonzero
    threshold, absolute at 0."""
    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    assert (np.abs(v - thresh) > margin * (abs(thresh) or 1.0)).all()


def intr(f=30.0, cx=20.0, cy=16.0):
    return np.asarray([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)


def posed_views(rng, V=3, H=32, W=40, shift=0.05):
    """Images [V, H, W, 3] and w2cs [V, 4, 4]: view 0 at the origin, the
    others shifted by normal(0, shift) (test_mvs.TestLearnedDepth)."""
    imgs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * V)
    for v in range(1, V):
        w2cs[v][:3, 3] = rng.normal(0, shift, 3)
    return imgs, w2cs


# ---------------------------------------------------------------------------
# warp
# ---------------------------------------------------------------------------

def test_project_to_view():
    rng = np.random.default_rng(0)
    H, W = 24, 32
    pts = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(-0.5, 3, 200)], -1).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    k = intr(20.0, 16, 12)
    xy, mask = JW.project_to_view(jnp.asarray(pts), jnp.asarray(c2w),
                                  jnp.asarray(w2c), jnp.asarray(k), H, W)
    gxy, gmask = TW.project_to_view(t(pts), t(c2w), t(w2c), t(k), H, W)
    close(gxy, xy)
    xy = np.asarray(xy)
    for v, hi in ((xy[..., 0], W - 1), (xy[..., 1], H - 1)):
        away(v, 0.0)
        away(v, hi)
    assert np.array_equal(n(gmask), np.asarray(mask))
    assert 0 < n(gmask).sum() < len(pts)


@pytest.mark.parametrize("H,W", [(6, 8), (7, 9)])
def test_plane_sweep_warp(H, W):
    """A random relative projection, planes partly behind the source
    camera (the safe divide's zeros), and its gradient in the features."""
    rng = np.random.default_rng(H)
    feat = rng.normal(size=(H, W, 4)).astype(np.float32)
    proj = np.concatenate([np.eye(3) + rng.normal(0, 0.05, (3, 3)),
                           rng.normal(0, 0.3, (3, 1))], 1).astype(np.float32)
    proj[2, 3] = -1.5                      # z < 0 on the nearest planes
    dv = np.linspace(0.5, 4.0, 8).astype(np.float32)
    want = JW.plane_sweep_warp(jnp.asarray(feat), jnp.asarray(proj),
                               jnp.asarray(dv))
    got = TW.plane_sweep_warp(t(feat), t(proj), t(dv))
    close(got, want)
    assert (np.asarray(want)[0] == 0).all() and (np.asarray(want)[-1] != 0
                                                 ).any()
    cot = rng.normal(size=want.shape).astype(np.float32)
    gj = jax.grad(lambda f: jnp.sum(JW.plane_sweep_warp(
        f, jnp.asarray(proj), jnp.asarray(dv)) * cot))(jnp.asarray(feat))
    ft = t(feat).requires_grad_(True)
    (TW.plane_sweep_warp(ft, t(proj), t(dv)) * t(cot)).sum().backward()
    close(ft.grad, gj)


def test_depth_regression_and_confidence_with_gradients():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(10, 5, 6)).astype(np.float32)
    dv = np.linspace(1, 3, 10).astype(np.float32)

    def jfn(lg):
        prob = jax.nn.softmax(lg, axis=0)
        d = JW.depth_regression(prob, jnp.asarray(dv))
        idx = JW.depth_regression(prob, jnp.arange(10, dtype=jnp.float32))
        return d, JW.photometric_confidence(prob, idx)

    def tfn(lg):
        prob = torch.softmax(lg, 0)
        d = TW.depth_regression(prob, t(dv))
        idx = TW.depth_regression(prob, torch.arange(10.0))
        return d, TW.photometric_confidence(prob, idx)

    (dj, cj) = jfn(jnp.asarray(logits))
    lt = t(logits).requires_grad_(True)
    dt, ct = tfn(lt)
    close(dt, dj)
    close(ct, cj)
    # the expected bin index, truncated: no index within the margin of an
    # integer, so the truncation picks the same bin in both
    idx = np.asarray(JW.depth_regression(jax.nn.softmax(jnp.asarray(logits),
                                                        0),
                                         jnp.arange(10, dtype=jnp.float32)))
    frac = idx - np.floor(idx)
    assert (np.minimum(frac, 1 - frac) > THRESH_MARGIN).all()
    gj = jax.grad(lambda lg: jnp.sum(jfn(lg)[0] * 2 + jfn(lg)[1]))(
        jnp.asarray(logits))
    (dt * 2 + ct).sum().backward()
    close(lt.grad, gj)


def test_photometric_confidence_truncates_the_bin_index():
    """Indices just under an integer (k - 1e-4) read bin k - 1, as torch's
    .long() and JAX's astype(int32) truncate; clipped into [0, D - 1]."""
    rng = np.random.default_rng(2)
    D = 8
    prob = rng.uniform(0, 1, (D, 2, 5)).astype(np.float32)
    idx = np.asarray([[0.9999, 2.9999, 3.0, 6.9999, 7.9999],
                      [-0.5, 0.0001, 4.5, 9.5, 1.99999]], np.float32)
    want = np.asarray(JW.photometric_confidence(jnp.asarray(prob),
                                                jnp.asarray(idx)))
    got = n(TW.photometric_confidence(t(prob), t(idx)))
    assert np.array_equal(got, want)
    pad = np.pad(prob, ((1, 2), (0, 0), (0, 0)))
    summed = pad[:-3] + pad[1:-2] + pad[2:-1] + pad[3:]
    bins = np.clip(np.trunc(idx).astype(int), 0, D - 1)
    assert bins[0].tolist() == [0, 2, 3, 6, 7]
    np.testing.assert_array_equal(got, np.take_along_axis(
        summed, bins[None], 0)[0])


def test_occlusion_mask():
    """Two layers of points along the same rays: the far layer is hidden
    (beyond `tolerate` of its bucket's least depth), the near one kept;
    points off the image or behind the camera are dropped."""
    rng = np.random.default_rng(3)
    H, W = 24, 32
    k = intr(20.0, 16, 12)
    pix = np.stack([rng.uniform(0.2, W - 1.2, 300),
                    rng.uniform(0.2, H - 1.2, 300)], -1)
    near = rng.uniform(1.0, 2.0, 300)
    ray = np.concatenate([(pix - k[:2, 2]) / 20.0, np.ones((300, 1))], -1)
    pts = np.concatenate([ray * near[:, None], ray * (near + 0.5)[:, None],
                          [[0, 0, -1.0], [50.0, 0, 1.0]]]).astype(np.float32)
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.01, 0.0, 0.0]
    for src in (None, np.eye(4, dtype=np.float32)):
        want = np.asarray(JW.occlusion_mask(
            jnp.asarray(pts), jnp.asarray(rel),
            None if src is None else jnp.asarray(src), jnp.asarray(k), H, W))
        got = n(TW.occlusion_mask(t(pts), t(rel),
                                  None if src is None else t(src), t(k), H,
                                  W))
        assert np.array_equal(got, want)
        assert got[:300].mean() > got[300:600].mean()
        assert not got[-2:].any()


@pytest.mark.parametrize("alpha_range", [False, True])
def test_alpha_masking(alpha_range):
    rng = np.random.default_rng(4)
    V, H, W = 3, 24, 32
    alphas = (rng.uniform(0, 1, (V, H, W)) > 0.3).astype(np.float32)
    k = intr(20.0, 16, 12)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * V)
    for v in range(1, V):
        w2cs[v][:3, 3] = rng.normal(0, 0.1, 3)
    xyz = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-1.5, 1.5, 500),
                    rng.uniform(0.3, 4, 500)], -1).astype(np.float32)
    for intrinsics in (k, np.stack([k] * V)):
        want = np.asarray(JW.alpha_masking(
            jnp.asarray(xyz), jnp.asarray(alphas), jnp.asarray(intrinsics),
            None, jnp.asarray(w2cs), near_far=(1.5, 3.5),
            alpha_range=alpha_range))
        got = n(TW.alpha_masking(t(xyz), t(alphas), t(intrinsics), None,
                                 t(w2cs), near_far=(1.5, 3.5),
                                 alpha_range=alpha_range))
        assert np.array_equal(got, want)
        assert 0 < got.sum() < len(xyz)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_bn_and_conv_bn(train):
    rng = np.random.default_rng(5)
    p = numpy_mvs_params(lambda k: JF.conv_bn_init(k, 3, 8, 5), 5)
    x = rng.normal(size=(2, 12, 14, 3)).astype(np.float32)
    for stride in (1, 2):
        want = JF.conv_bn_apply(jax_tree(p), jnp.asarray(x), stride, train)
        got = TF.conv_bn_apply(from_jax.params_from_numpy(p, CPU), t(x),
                               stride, train)
        close(got, want)


def test_feature_net():
    rng = np.random.default_rng(6)
    p = numpy_mvs_params(JF.feature_net_init, 6)
    imgs = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    want = jax.jit(JF.feature_net_apply)(jax_tree(p), jnp.asarray(imgs))
    got = TF.feature_net_apply(from_jax.params_from_numpy(p, CPU), t(imgs))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        close(g, w)
    only = TF.feature_net_apply(from_jax.params_from_numpy(p, CPU), t(imgs),
                                intermediate=False)
    assert len(only) == 1 and torch.equal(only[0], got[3])


@pytest.mark.parametrize("extent", [(8, 6, 8), (7, 5, 9)])
def test_transpose_conv_same_in_both_formulations(extent):
    """features.py's upsampling is jax.lax.conv_transpose(..., "SAME"),
    kernel not flipped: the port's conv_transpose_same equals it on even
    and odd extents, and torch's ConvTranspose3d(padding=1,
    output_padding=1) formulation (mvsnet.py's) does not."""
    rng = np.random.default_rng(sum(extent))
    x = rng.normal(size=extent + (6,)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 6, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x)[None], jnp.asarray(w), (2, 2, 2), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))[0])
    got = TF.to_dhwc(TF.conv_transpose_same(TF.to_ncdhw(t(x)), t(w)))
    close(got, want)
    assert want.shape[:3] == tuple(2 * e for e in extent)
    torch_style = TF.to_dhwc(F.conv_transpose3d(
        TF.to_ncdhw(t(x)), torch.flip(t(w), (0, 1, 2)).permute(3, 4, 0, 1, 2),
        stride=2, padding=1, output_padding=1))
    assert torch_style.shape == got.shape
    assert np.abs(n(torch_style) - want).max() > 0.1 * np.abs(want).max()
    # and mvsnet.py's upsampling is that torch formulation
    want_m = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x)[None], jnp.asarray(w), (1, 1, 1), ((1, 2),) * 3,
        lhs_dilation=(2, 2, 2),
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))[0])
    close(torch_style, want_m)


@pytest.mark.parametrize("extent", [(8, 6, 8), (7, 5, 9)])
def test_cost_reg_and_prob_net(extent):
    rng = np.random.default_rng(7)
    p = numpy_mvs_params(lambda k: JF.cost_reg_init(k, 32), 7)
    pn = numpy_mvs_params(lambda k: JF.prob_net_init(k, 8), 8)
    vol = rng.normal(size=extent + (32,)).astype(np.float32)
    for train in (False, True):
        want = jax.jit(JF.cost_reg_apply, static_argnums=2)(
            jax_tree(p), jnp.asarray(vol), train)
        got = TF.cost_reg_apply(from_jax.params_from_numpy(p, CPU), t(vol),
                                train)
        close(got, want)
        close(TF.prob_net_apply(from_jax.params_from_numpy(pn, CPU), got,
                                train),
              JF.prob_net_apply(jax_tree(pn), want, train))


# ---------------------------------------------------------------------------
# mvsnet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extent", [(8, 6, 8), (7, 5, 9)])
def test_mvsnet_cost_reg(extent):
    rng = np.random.default_rng(9)
    p = numpy_mvs_params(JM.cost_reg_init, 9)
    vol = rng.normal(size=extent + (32,)).astype(np.float32)
    want = jax.jit(JM.cost_reg_apply)(jax_tree(p), jnp.asarray(vol))
    close(TM.cost_reg_apply(from_jax.params_from_numpy(p, CPU), t(vol)),
          want)


def test_mvsnet_feature_and_proj():
    rng = np.random.default_rng(10)
    p = numpy_mvs_params(JM.feature_init, 10)
    imgs = rng.uniform(0, 1, (3, 32, 40, 3)).astype(np.float32)
    close(TM.feature_apply(from_jax.params_from_numpy(p, CPU), t(imgs)),
          jax.jit(JM.feature_apply)(jax_tree(p), jnp.asarray(imgs)))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, 0.2, -0.1]
    close(TM.build_proj(t(intr()), t(w2c)),
          JM.build_proj(jnp.asarray(intr()), jnp.asarray(w2c)))


def _jax_depth(params, imgs, k, w2cs, dv):
    return jax.jit(JM.depth_from_views)(params, jnp.asarray(imgs),
                                         jnp.asarray(k), jnp.asarray(w2cs),
                                         jnp.asarray(dv))


def test_depth_from_views_and_unprojection():
    rng = np.random.default_rng(11)
    p = numpy_mvs_params(JM.init, 11)
    imgs, w2cs = posed_views(rng)
    dv = np.linspace(2.0, 4.0, 8).astype(np.float32)
    dj, cj = _jax_depth(jax_tree(p), imgs, intr(), w2cs, dv)
    dt, ct = TM.depth_from_views(from_jax.params_from_numpy(p, CPU), t(imgs),
                                 t(intr()), t(w2cs), t(dv))
    close(dt, dj)
    close(ct, cj)
    assert dt.shape == (8, 10)
    kq = intr()
    kq[:2] *= 0.25
    close(TM.depth_to_cam_xyz(dt, t(kq)),
          JM.depth_to_cam_xyz(dj, jnp.asarray(kq)))


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def _depth_views(rng, V=3, H=16, W=20):
    """V cameras along x, one pixel apart at the wall z = 2 they look at:
    depths [V, H, W] of 2 m, in a third of the pixels off by +-1.5% (those
    fail the 1% test against the other views; whole-pixel shifts keep the
    bilinear samples from mixing them, so no rel lies near 1%),
    intrinsics and w2cs."""
    f = 15.0
    k = intr(f, W / 2, H / 2)
    depths, w2cs = [], []
    for v in range(V):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = v * 2.0 / f
        w2cs.append(np.linalg.inv(c2w).astype(np.float32))
        noisy = rng.uniform(0, 1, (H, W)) < 0.33
        d = 2.0 * np.where(noisy, 1.0 + rng.choice([-1, 1], (H, W)) * 0.015,
                           1.0)
        depths.append(d.astype(np.float32))
    return (np.stack(depths), np.stack([k] * V), np.stack(w2cs))


def _consistency_margins(depths, ks, ex):
    """JAX's dist and rel of every ordered pair of views."""
    out = []
    for r in range(len(depths)):
        for s in range(len(depths)):
            if r == s:
                continue
            drep, xyrep = JGF.reproject_with_depth(
                *(jnp.asarray(a) for a in (depths[r], ks[r], ex[r],
                                           depths[s], ks[s], ex[s])))
            H, W = depths[r].shape
            ys, xs = np.mgrid[0:H, 0:W]
            xyrep = np.asarray(xyrep)
            dist = np.sqrt((xyrep[..., 0] - xs) ** 2
                           + (xyrep[..., 1] - ys) ** 2)
            rel = np.abs(np.asarray(drep) - depths[r]) / depths[r]
            out.append((dist, rel))
    return out


def test_geometric_consistency_and_filter():
    rng = np.random.default_rng(12)
    depths, ks, ex = _depth_views(rng)
    for dist, rel in _consistency_margins(depths, ks, ex):
        away(dist, 1.0, 1e-3)
        away(rel, 0.01, 1e-3)
    args = [(depths[0], ks[0], ex[0], depths[1], ks[1], ex[1])]
    for a in args:
        dj, xyj = JGF.reproject_with_depth(*map(jnp.asarray, a))
        dt, xyt = TGF.reproject_with_depth(*map(t, a))
        close(dt, dj)
        close(xyt, xyj)
        mj, rj = JGF.check_geometric_consistency(*map(jnp.asarray, a))
        mt, rt = TGF.check_geometric_consistency(*map(t, a))
        assert np.array_equal(n(mt), np.asarray(mj))
        close(rt, rj)
    conf = rng.uniform(0, 1, depths.shape).astype(np.float32)
    away(conf, 0.5)
    for geo in (0, 1, 2):
        want = JGF.filter_depths(jnp.asarray(depths), jnp.asarray(ks),
                                 jnp.asarray(ex), jnp.asarray(conf), 0.5, geo)
        got = TGF.filter_depths(t(depths), t(ks), t(ex), t(conf), 0.5, geo)
        assert np.array_equal(n(got[0]), np.asarray(want[0]))
        close(got[1], want[1])
        assert np.array_equal(n(got[2]), np.asarray(want[2]))
        assert got[2].dtype == torch.int32
        close(TGF.reassign_conf(t(conf), got[2], geo),
              JGF.reassign_conf(jnp.asarray(conf), want[2], geo))
    # some pixels pass the filter and some do not
    m = n(got[0])
    assert 0 < m.sum() < m.size
    # one view alone: the confidence test alone
    one = TGF.filter_depths(t(depths[:1]), t(ks[:1]), t(ex[:1]),
                            t(conf[:1]), 0.5, 2)
    assert np.array_equal(n(one[0]), conf[:1] > 0.5)


# ---------------------------------------------------------------------------
# point_gen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(use_mvsnet=False),
                                dict(use_mvsnet=False, use_probnet=True),
                                dict(use_premlp=False, use_probnet=True)])
def test_init_tree_and_shapes_equal_jax(kw):
    want = jax.eval_shape(lambda k: JP.init(k, 16, **kw),
                          jax.random.PRNGKey(0))
    got = TP.init(torch.Generator().manual_seed(0), 16, **kw)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is None:
            continue
        ja = jax.tree_util.tree_flatten_with_path(a)[0]
        paths = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in ja]
        mine = []

        def walk(node, prefix):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], f"{prefix}['{k}']")
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, f"{prefix}[{i}]")
            else:
                mine.append((prefix, tuple(node.shape)))
        walk(b, "")
        assert mine == paths
        assert all(x.dtype == torch.float32 for x in TS.tree_leaves(b))


def _query_case(rng, use_premlp=True):
    p = numpy_mvs_params(lambda k: JP.init(k, 16, use_mvsnet=False,
                                           use_premlp=use_premlp), 13)
    N = 60
    cam_xyz = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.5, 0.5, N),
                        rng.uniform(1.5, 2.5, N)], -1).astype(np.float32)
    imgs, w2cs = posed_views(rng, H=24, W=32, shift=0.1)
    c2ws = np.stack([np.linalg.inv(w) for w in w2cs]).astype(np.float32)
    return p, cam_xyz, imgs, c2ws, w2cs


@pytest.mark.parametrize("use_premlp,cam_vid,with_conf", [
    (True, 0, True), (True, 1, False), (False, 0, False)])
def test_query_embedding(use_premlp, cam_vid, with_conf):
    rng = np.random.default_rng(14)
    p, cam_xyz, imgs, c2ws, w2cs = _query_case(rng, use_premlp)
    k = intr(20.0, 16, 12)
    conf = rng.uniform(0, 1, len(cam_xyz)).astype(np.float32)
    want = JP.query_embedding(
        jax_tree(p), jnp.asarray(cam_xyz), jnp.asarray(imgs),
        jnp.asarray(c2ws), jnp.asarray(w2cs), jnp.asarray(k), cam_vid,
        confidence=jnp.asarray(conf) if with_conf else None)
    got = TP.query_embedding(
        from_jax.mvs_params_from_numpy(p, CPU), t(cam_xyz), t(imgs),
        t(c2ws), t(w2cs), t(k), cam_vid,
        confidence=t(conf) if with_conf else None)
    for g, w in zip(got, want):
        close(g, w)
    assert got[0].shape == ((len(cam_xyz), 16) if use_premlp
                            else (len(cam_xyz), TP.IMGFEAT_CHANNELS))


def test_gen_points_three_modes():
    rng = np.random.default_rng(15)
    imgs, w2cs = posed_views(rng)
    k = intr()
    p = numpy_mvs_params(lambda key: JP.init(key, 8, use_probnet=True), 15)
    jp, tp = jax_tree(p), from_jax.mvs_params_from_numpy(p, CPU)
    # pretrained MVSNet at 1/4, then the learned ProbNet volume
    for learned, thresh in ((False, 0.3), (True, 0.3)):
        want = jax.jit(JP.gen_points, static_argnums=(4, 5, 6),
                       static_argnames=("conf_thresh", "learned"))(
            jp, jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(w2cs), 1.0,
            3.0, 16, conf_thresh=thresh, learned=learned)
        got = TP.gen_points(tp, t(imgs), t(k), t(w2cs), 1.0, 3.0, 16,
                            conf_thresh=thresh, learned=learned)
        close(got[0], want[0])
        close(got[1], want[1])
        away(np.asarray(want[1]), thresh)
        assert np.array_equal(n(got[2]), np.asarray(want[2]))
        assert got[0].shape == (8 * 10, 3)
    # sensor depth at full resolution
    depth = rng.uniform(0.0, 3.0, (32, 40)).astype(np.float32)
    depth[depth < 0.5] = 0.0
    want = JP.gen_points(jp, jnp.asarray(imgs), jnp.asarray(k),
                         jnp.asarray(w2cs), 1.0, 3.0,
                         depth_gt=jnp.asarray(depth), conf_thresh=0.8)
    got = TP.gen_points(tp, t(imgs), t(k), t(w2cs), 1.0, 3.0,
                        depth_gt=t(depth), conf_thresh=0.8)
    close(got[0], want[0])
    assert np.array_equal(n(got[2]), np.asarray(want[2]))
    assert n(got[2]).sum() == (depth > 0).sum()


def test_gen_depth_learned_gradient_reaches_every_part():
    """The learned depth differentiates into the FeatureNet, the U-Net and
    ProbNet (batch-norm statistics included), as JAX's does."""
    rng = np.random.default_rng(16)
    imgs, w2cs = posed_views(rng)
    k = intr()
    p = numpy_mvs_params(lambda key: JP.init(key, 8, use_mvsnet=False,
                                             use_probnet=True), 16)

    def jloss(params):
        d, c, _ = JP.gen_depth_learned(params, jnp.asarray(imgs),
                                       jnp.asarray(k), jnp.asarray(w2cs),
                                       1.0, 3.0, num_depths=8)
        return jnp.mean(d) + jnp.mean(c)

    gj = jax.jit(jax.grad(jloss))(jax_tree(p))
    tp = TP.map_params(lambda x: x.requires_grad_(True),
                       from_jax.mvs_params_from_numpy(p, CPU))
    d, c, _ = TP.gen_depth_learned(tp, t(imgs), t(k), t(w2cs), 1.0, 3.0,
                                   num_depths=8)
    (d.mean() + c.mean()).backward()
    scale = max(float(jnp.abs(x).max()) for x in jax.tree_util.tree_leaves(gj))
    for part_j, part_t in zip(gj, tp):
        if part_j is None:
            continue
        for a, b in zip(jax.tree_util.tree_leaves(part_j),
                        [x.grad for x in _sorted_leaves(part_t)]):
            got = np.zeros(a.shape, np.float32) if b is None else n(b)
            np.testing.assert_allclose(got, np.asarray(a), rtol=1e-3,
                                       atol=1e-4 * scale)
    bn_mean = tp.cost_reg["c0"]["bn"]["mean"].grad
    assert bn_mean is not None and float(bn_mean.abs().max()) > 0


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the MVSNet importer
# ---------------------------------------------------------------------------

def test_import_mvsnet_leaf_for_leaf(tmp_path):
    """One seeded reference-layout state_dict through both importers, as a
    dict and as a .ckpt the trainer's way ({"model": module.-prefixed}):
    every leaf equal; and depth_from_views on the imported weights."""
    sd = mvsnet_state_dict(17)
    want = JTI.import_mvsnet(sd)
    path = save_mvsnet_ckpt(tmp_path / "model_000014.ckpt", sd)
    loaded = TTI.load_torch_state_dict(path)
    assert set(loaded) == set(sd)
    assert set(JTI.load_torch_state_dict(path)) == set(sd)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    for got in (TTI.import_mvsnet(sd, device=CPU),
                TTI.import_mvsnet({k: torch.as_tensor(v)
                                   for k, v in sd.items()}, device=CPU),
                TTI.import_mvsnet(loaded, device=CPU)):
        gl = _sorted_leaves(got)
        assert len(gl) == len(wl) == 7 * 5 + 2 + 10 * 5 + 2
        for (path_, a), b in zip(wl, gl):
            assert b.dtype == torch.float32 and b.is_contiguous()
            assert np.array_equal(n(b), np.asarray(a)), \
                jax.tree_util.keystr(path_)
    with pytest.raises(KeyError, match="prob.bias"):
        TTI.import_mvsnet({k: v for k, v in sd.items()
                           if k != "cost_regularization.prob.bias"},
                          device=CPU)
    rng = np.random.default_rng(18)
    imgs, w2cs = posed_views(rng)
    dv = np.linspace(2.0, 4.0, 8).astype(np.float32)
    dj, cj = _jax_depth(want, imgs, intr(), w2cs, dv)
    dt, ct = TM.depth_from_views(TTI.import_mvsnet(loaded, device=CPU),
                                 t(imgs), t(intr()), t(w2cs), t(dv))
    close(dt, dj)
    close(ct, cj)
    assert os.path.getsize(path) > 0


def test_mvs_params_from_numpy_keeps_absent_parts():
    p = numpy_mvs_params(lambda k: JP.init(k, 8, use_mvsnet=False), 19)
    got = from_jax.mvs_params_from_numpy(p, CPU)
    assert got.mvsnet is None and got.cost_reg is None
    assert got.prob_net is None and got.premlp is not None
    assert np.array_equal(n(got.feature["top"]["w"]),
                          p.feature["top"]["w"])
    with pytest.raises(ValueError, match="parts"):
        from_jax.mvs_params_from_numpy(tuple(p)[:3], CPU)
