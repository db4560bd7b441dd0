"""The port's MVS bootstrap (train/bootstrap.py, data/paths.
build_view_triplets, cli/train.py --load-points 0) against the JAX
package, on the CPU.

Weights are seeded numpy trees of JAX's shapes, or JAX's own initial MVS
networks in the CLI runs (carried across through the port's init_mvs).
Tolerances:

- the triplets: equal;
- the cloud and its attributes: the same count; xyz, embedding, colour,
  direction and confidence rtol 1e-5 / atol 1e-5 * max|JAX| (the
  convolutions and products sum in another order);
- masks that follow a threshold must be equal, so each case asserts that
  its JAX values lie clear of them: the cross-group consistency's dist and
  rel at least 1e-3 (relative) from 1 px and 1%, every voxel coordinate
  of the downsample at least 1e-4 of a voxel from a voxel face; the
  confidences of the MVSNet runs clear of their threshold 0 (random
  weights give about 0.5);

Both CLIs' --load-points 0 runs are in tests/test_torch_port_bootstrap_cli.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.data import nerf_synth as jnerf
from hybridneuralrendering_tpu.data import paths as jpaths
from hybridneuralrendering_tpu.mvs import filter as JGF
from hybridneuralrendering_tpu.mvs import point_gen as JP
from hybridneuralrendering_tpu.train import bootstrap as jbs
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.cli import train as tcli
from hybridneuralrendering_tpu_torch.data import nerf_synth as tnerf
from hybridneuralrendering_tpu_torch.data import paths as tpaths
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.train import bootstrap as tbs
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    jax_tree, numpy_mvs_params, one_torch_thread)

CPU = "cpu"
ATTRS = ("embedding", "color", "dirs", "conf")


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(
        float(np.abs(want).max()) if want.size else 0.0, 1e-30))


@pytest.mark.parametrize("n,max_groups", [(10, 0), (10, 3), (7, 0), (2, 0),
                                          (3, 1)])
def test_build_view_triplets_bitwise(n, max_groups):
    rng = np.random.default_rng(n)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    want = jpaths.build_view_triplets(pos, max_groups)
    got = tpaths.build_view_triplets(pos, max_groups)
    assert got == want
    assert all(type(i) is int for g in got for i in g)
    if max_groups:
        assert len(got) <= max_groups


def _cfg(pkg, ranges=(-3.0, -3.0, -1.0, 3.0, 3.0, 2.6)):
    cfg = pkg.tiny_test()
    return cfg.replace(querier=dataclasses.replace(cfg.querier,
                                                   ranges=ranges))


def _groups(rng, G=3, H=32, W=40, step=0.41):
    """G triplets along x, each reference view `step` m from the last
    (about 1.5 quarter-resolution pixels at the depth random weights
    estimate: the reference views overlap, and the pixels whose
    reprojection leaves the other views fail the cross-group test)."""
    images, w2cs = [], []
    for g in range(G):
        imgs = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
        c2ws = np.stack([np.eye(4, dtype=np.float32)] * 3)
        c2ws[:, 0, 3] = step * g
        c2ws[1, 0, 3] += 0.05
        c2ws[2, 1, 3] += 0.05
        images.append(imgs)
        w2cs.append(np.linalg.inv(c2ws).astype(np.float32))
    k = np.asarray([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                   np.float32)
    return images, w2cs, k


def _vox_clear(xyz, vox_res, margin=1e-4):
    """Every point's voxel coordinate (data/point_init._vox_ids) at least
    `margin` of a voxel from a face."""
    mn, mx = xyz.min(0), xyz.max(0)
    edge = np.max(mx - mn) * 1.05
    v = (xyz - ((mx + mn) / 2 - edge / 2)) / (np.full(3, edge) / vox_res)
    frac = v - np.floor(v)
    assert (np.minimum(frac, 1 - frac) > margin).all()


def _both(jparams, tparams, images, w2cs, k, cfg_j, cfg_t, near=1.0,
          far=3.0, **kw):
    want = jbs.bootstrap_from_groups(jparams, images, k, w2cs, near, far,
                                     cfg_j, **kw)
    got = tbs.bootstrap_from_groups(tparams, images, k, w2cs, near, far,
                                    cfg_t, device=CPU, **kw)
    assert len(got[0]) == len(want[0]) > 0
    close(got[0], want[0])
    for a in ATTRS:
        close(got[1][a], want[1][a])
    return want


def test_bootstrap_mvsnet_mode_with_cross_group_filter():
    rng = np.random.default_rng(0)
    images, w2cs, k = _groups(rng)
    p = numpy_mvs_params(lambda key: JP.init(key, 8), 0)
    jp, tp = jax_tree(p), from_jax.mvs_params_from_numpy(p, CPU)
    # the depth maps JAX's filter sees, and its dist / rel margins
    depths, confs = [], []
    for imgs, w in zip(images, w2cs):
        d, c, kq = JP.gen_depth(jp, jnp.asarray(imgs), jnp.asarray(k),
                                jnp.asarray(w), 1.0, 3.0, 96)
        depths.append(np.asarray(d))
        confs.append(np.asarray(c))
    kq = np.asarray(kq)
    assert (np.stack(confs) > 1e-3).all()
    ex = [w[0] for w in w2cs]
    for r in range(3):
        for s in range(3):
            if r == s:
                continue
            drep, xyrep = JGF.reproject_with_depth(
                *(jnp.asarray(a) for a in (depths[r], kq, ex[r], depths[s],
                                           kq, ex[s])))
            h, w = depths[r].shape
            ys, xs = np.mgrid[0:h, 0:w]
            xyrep = np.asarray(xyrep)
            with np.errstate(invalid="ignore"):
                dist = np.sqrt((xyrep[..., 0] - xs) ** 2
                               + (xyrep[..., 1] - ys) ** 2)
                rel = np.abs(np.asarray(drep) - depths[r]) / depths[r]
                for v, th in ((dist, 1.0), (rel, 0.01)):
                    v = v[np.isfinite(v)]
                    assert (np.abs(v - th) > 1e-3 * th).all()
    kw = dict(conf_thresh=0.0, geo_cnsst_num=2, num_depths=96)
    cfg_j, cfg_t = _cfg(JC), _cfg(TC)
    want = _both(jp, tp, images, w2cs, k, cfg_j, cfg_t, vox_res=0, **kw)
    # the filter rejects some pixels: fewer points than the groups' pixels
    assert len(want[0]) < 3 * depths[0].size
    # an odd resolution: the flat cloud's mid-plane falls inside a voxel
    _vox_clear(want[0], 11)
    ds = _both(jp, tp, images, w2cs, k, cfg_j, cfg_t, vox_res=11, **kw)
    assert len(ds[0]) < len(want[0])


def test_bootstrap_gt_depth_mode():
    rng = np.random.default_rng(1)
    images, w2cs, k = _groups(rng, G=2, H=24, W=32, step=0.1)
    k = np.asarray([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    depth = [np.where(rng.uniform(0, 1, (24, 32)) < 0.2, 0.0,
                      1.5 + 0.2 * g + rng.uniform(0, 0.1, (24, 32)))
             .astype(np.float32) for g in range(2)]
    # the points reproject onto view 0's pixel grid exactly: zero depth on
    # its border, so none lies on the edge of the in-bounds test
    for d in depth:
        d[[0, -1]] = 0.0
        d[:, [0, -1]] = 0.0
    p = numpy_mvs_params(lambda key: JP.init(key, 8, use_mvsnet=False), 1)
    jp, tp = jax_tree(p), from_jax.mvs_params_from_numpy(p, CPU)
    cfg_j, cfg_t = _cfg(JC), _cfg(TC)
    want = _both(jp, tp, images, w2cs, k, cfg_j, cfg_t,
                 depth_gt_by_group=depth, vox_res=0)
    assert len(want[0]) == sum(int((d > 0).sum()) for d in depth)
    _vox_clear(want[0], 15)
    _both(jp, tp, images, w2cs, k, cfg_j, cfg_t, depth_gt_by_group=depth,
          vox_res=15)


def _blender_cfg(pkg):
    cfg = pkg.tiny_test()
    return cfg.replace(
        querier=dataclasses.replace(
            cfg.querier, ranges=(-1.2, -1.2, -1.2, 1.2, 1.2, 1.2)),
        render=dataclasses.replace(cfg.render, near_plane=2.0,
                                   far_plane=6.0),
        image_hw=(32, 32))


def test_alpha_hull_on_a_blender_scene(tmp_path):
    """The port's write_blender_scene object (8 training views at 32x32):
    the triplets of both Blender classes equal, the groups' views as
    cli.train.group_views reads them equal to JAX's reads, and the
    GT-depth bootstrap of two triplets (jittered depth around the orbit's
    radius) cut to the visual hull of the triplets' other views' alpha
    mattes, equal to JAX's.  The
    hull's floor() of each projection and its near / far test follow a
    threshold: every point lies at least 1e-5 px (float32 puts a
    projection within about 4e-6 px) and 1e-4 m clear of them."""
    tsyn.write_blender_scene(str(tmp_path), "obj", n_train=8, n_test=2,
                             hw=(32, 32), num_points=500)
    jc, tc = _blender_cfg(JC), _blender_cfg(TC)
    jds = jnerf.NerfSynthScene(str(tmp_path), "obj", jc, "train")
    tds = tnerf.NerfSynthScene(str(tmp_path), "obj", tc, "train")
    groups = tbs.groups_from_dataset(tds)
    assert groups == jbs.groups_from_dataset(jds) and len(groups) >= 2
    groups = groups[:2]
    images, w2cs = [], []
    for g in groups:
        imgs, w = tcli.group_views(tds, g)
        assert np.array_equal(imgs, np.stack([jds.train_image(i)
                                              for i in g]))
        assert np.array_equal(w, np.stack([np.linalg.inv(jds.c2w(
            i, jds.train_meta)) for i in g]).astype(np.float32))
        images.append(imgs)
        w2cs.append(w)
    # the hull's views: the triplets' other views (a point of a reference
    # view projects back onto its own pixel grid, where floor() is a tie)
    vids = sorted({i for g in groups for i in g[1:]} - {g[0] for g in groups})
    alphas = np.stack([tds.train_alpha(i) for i in vids])
    assert np.array_equal(alphas, np.stack([jds.train_alpha(i)
                                            for i in vids]))
    alpha_w2cs = np.stack([np.linalg.inv(tds.c2w(i, tds.train_meta))
                           for i in vids]).astype(np.float32)
    rng = np.random.default_rng(3)
    # a quarter of the pixels carry depth: fewer points near a pixel edge
    depth = [np.where(rng.uniform(0, 1, (32, 32)) < 0.25,
                      rng.uniform(3.4, 4.6, (32, 32)), 0.0).astype(np.float32)
             for _ in groups]
    p = numpy_mvs_params(lambda key: JP.init(key, 8, use_mvsnet=False), 3)
    jp, tp = jax_tree(p), from_jax.mvs_params_from_numpy(p, CPU)
    kw = dict(depth_gt_by_group=depth, vox_res=0)
    k = tds.intrinsic
    pre, _ = jbs.bootstrap_from_groups(jp, images, k, w2cs, 2.0, 6.0, jc,
                                       **kw)
    xyz1 = np.concatenate([pre, np.ones((len(pre), 1), np.float32)], -1)
    for w in alpha_w2cs:
        cam = xyz1 @ w.T
        pix = cam[:, :3] @ k.T
        uv = pix[:, :2] / pix[:, 2:]
        assert (np.abs(uv - np.round(uv)) > 1e-5).all()
        assert (np.abs(cam[:, 2] - 1.0) > 1e-4).all()
        assert (np.abs(cam[:, 2] - 6.0) > 1e-4).all()
    want = _both(jp, tp, images, w2cs, k, jc, tc, alphas=alphas,
                 alpha_w2cs=alpha_w2cs, near=2.0, far=6.0, **kw)
    assert 0 < len(want[0]) < len(pre)
