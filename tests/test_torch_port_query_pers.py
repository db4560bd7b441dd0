"""The port's perspective-space querier (ops/query_pers.py) and camera
helpers (core/cameras.pers2w, get_dtu_raydir) against the JAX package's.

The scene is tests/test_query_pers.py's: 600 points in front of a camera
at the origin, 48 x 64 pixels.  Tolerances:
- frustum geometry: equal (the same numpy float32 arithmetic), the
  capacity error raised by both;
- the frustum grid: every id table, count and occupancy bit equal; the
  tables holding perspective coordinates within 1e-6 relative (JAX
  rotates with a matmul, the port with products written out, which round
  alike on the card and the CPU; the two differ by float32 rounding);
- the query: sample_pidx, sample_mask, pnt_mask and ray_mask equal,
  sample_loc_w within 1e-5 relative (ROADMAP Queue 3: the float32
  rounding of the perspective round trip);
- pers2w, get_dtu_raydir: 1e-6 relative (1e-7 absolute for coordinates
  near 0, where JAX's matmul and torch's round apart by an ulp of the
  larger terms), pers2w(w2pers(x)) = x within 1e-5.
The training jitters take JAX's draws: the candidates' uniform noise from
the key, the shading points' from fold_in(key, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.config import QuerierConfig as JQC
from hybridneuralrendering_tpu.core import cameras as jcam
from hybridneuralrendering_tpu.ops import query_pers as JQP
from hybridneuralrendering_tpu_torch.config import QuerierConfig as TQC
from hybridneuralrendering_tpu_torch.core import cameras as tcam
from hybridneuralrendering_tpu_torch.ops import query_pers as TQP
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    n, one_torch_thread, t)

QCFG = dict(
    vsize=(0.01, 0.01, 0.05), vscale=(2, 2, 2), kernel_size=(3, 3, 3),
    query_size=(3, 3, 3), z_depth_dim=64, SR=8, K=4, P=16, max_o=8192,
    ranges=(-9.0,) * 3 + (9.0,) * 3, grid_capacity=2_000_000,
    radius_limit_scale=0.0, sample_jitter=0.0, Ps=32, max_nodes=60_000)
INTR = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
H, W, NEAR, FAR = 48, 64, 0.5, 4.0
ID_TABLES = ("coor2occ", "occ_dilated", "occ_pnts", "occ_numpnts", "num_occ",
             "coor2node", "num_nodes", "occ_bits")


def _camera(kind):
    if kind == "identity":
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return rot, np.array([0.1, -0.05, 0.2], np.float32)


def _points(num=600, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.5, 0.5, (num, 3)).astype(np.float32)
    xyz[:, 2] += 2.0
    return xyz


def _setup(kind="identity", **over):
    jcfg, tcfg = JQC(**{**QCFG, **over}), TQC(**{**QCFG, **over})
    xyz = _points()
    rot, pos = _camera(kind)
    jgeom = JQP.frustum_geometry(INTR, H, W, NEAR, FAR, jcfg)
    tgeom = TQP.frustum_geometry(INTR, H, W, NEAR, FAR, tcfg, device="cpu")
    mask = np.ones(len(xyz), bool)
    jgrid = JQP.build_frustum_grid(jnp.asarray(xyz), jnp.asarray(mask),
                                   jnp.asarray(rot), jnp.asarray(pos), jgeom,
                                   jcfg)
    tgrid = TQP.build_frustum_grid(t(xyz), t(mask), t(rot), t(pos), tgeom,
                                   tcfg)
    return (jcfg, tcfg), xyz, (rot, pos), (jgrid, tgrid)


def _rays(xyz, pos, num_hit=12, num_random=20, seed=1):
    """Rays at some of the points, and random rays through the frustum."""
    rng = np.random.default_rng(seed)
    dirs = xyz[rng.integers(0, len(xyz), num_hit)] - pos
    rnd = np.stack([rng.uniform(-0.5, 0.5, num_random),
                    rng.uniform(-0.4, 0.4, num_random),
                    np.ones(num_random)], -1)
    dirs = np.concatenate([dirs, rnd]).astype(np.float32)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@pytest.mark.parametrize("hw,near,far", [((48, 64), 0.5, 4.0),
                                         ((30, 41), 0.1, 8.0),
                                         ((480, 640), 0.3, 6.5)])
def test_frustum_geometry_equal(hw, near, far):
    intr = np.array([[61.3, 0, hw[1] / 2 + 0.7], [0, 59.1, hw[0] / 2 - 1.2],
                     [0, 0, 1]], np.float32)
    cfg = dict(QCFG, grid_capacity=10 ** 9)
    j = JQP.frustum_geometry(intr, *hw, near, far, JQC(**cfg))
    p = TQP.frustum_geometry(intr, *hw, near, far, TQC(**cfg), device="cpu")
    np.testing.assert_array_equal(n(p.origin), np.asarray(j.origin))
    np.testing.assert_array_equal(n(p.vsize), np.asarray(j.vsize))
    assert p.dims == tuple(int(d) for d in np.asarray(j.dims))


def test_frustum_geometry_capacity_error():
    """Both raise once dims[0] * dims[1] * (dims[2] + 2) passes the
    capacity, and neither at exactly it."""
    g = JQP.frustum_geometry(INTR, H, W, NEAR, FAR, JQC(**QCFG))
    d = [int(x) for x in np.asarray(g.dims)]
    total = d[0] * d[1] * (d[2] + 2)
    for cap, raises in ((total, False), (total - 1, True)):
        cfg = dict(QCFG, grid_capacity=cap)
        for fn, qc, kw in ((JQP.frustum_geometry, JQC, {}),
                           (TQP.frustum_geometry, TQC, {"device": "cpu"})):
            if raises:
                with pytest.raises(ValueError, match="exceeds capacity"):
                    fn(INTR, H, W, NEAR, FAR, qc(**cfg), **kw)
            else:
                fn(INTR, H, W, NEAR, FAR, qc(**cfg), **kw)


@pytest.mark.parametrize("kind", ["identity", "rotated"])
def test_build_frustum_grid_equal(kind):
    _, _, _, (jgrid, tgrid) = _setup(kind)
    assert int(tgrid.num_occ) > 100
    for name in ID_TABLES:
        np.testing.assert_array_equal(n(getattr(tgrid, name)),
                                      np.asarray(getattr(jgrid, name)),
                                      err_msg=name)
    # the node buckets: ids equal, perspective coordinates to rounding
    Ps = QCFG["Ps"]
    jb, tb = np.asarray(jgrid.node_bucket), n(tgrid.node_bucket)
    np.testing.assert_array_equal(tb[:, 3 * Ps:].view(np.int32),
                                  jb[:, 3 * Ps:].view(np.int32))
    np.testing.assert_allclose(tb[:, :3 * Ps], jb[:, :3 * Ps], rtol=1e-6)
    np.testing.assert_allclose(n(tgrid.occ_pnt_xyz),
                               np.asarray(jgrid.occ_pnt_xyz), rtol=1e-6)


def test_points_behind_camera_excluded():
    (jcfg, tcfg), xyz, (rot, pos), (_, tgrid) = _setup()
    behind = xyz.copy()
    behind[:, 2] -= 4.0
    half = np.concatenate([xyz[:300], behind[300:]])
    mask = np.ones(len(xyz), bool)
    for pts, live in ((behind, 0), (half, None)):
        g = TQP.build_frustum_grid(t(pts), t(mask), t(rot), t(pos),
                                   tgrid.geom, tcfg)
        jg = JQP.build_frustum_grid(jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(rot), jnp.asarray(pos),
                                    JQP.frustum_geometry(INTR, H, W, NEAR,
                                                         FAR, jcfg), jcfg)
        assert int(g.num_occ) == int(jg.num_occ)
        if live == 0:
            assert int(g.num_occ) == 0
        np.testing.assert_array_equal(n(g.occ_pnts), np.asarray(jg.occ_pnts))


def _compare(jres, tres):
    for name in ("sample_pidx", "sample_mask", "pnt_mask", "ray_mask"):
        np.testing.assert_array_equal(n(getattr(tres, name)),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    np.testing.assert_allclose(n(tres.sample_loc_w),
                               np.asarray(jres.sample_loc_w), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "rotated"])
def test_query_points_pers_equal(kind):
    (jcfg, tcfg), xyz, (rot, pos), (jgrid, tgrid) = _setup(kind)
    dirs = _rays(xyz, pos)
    jres = JQP.query_points_pers(jgrid, jnp.asarray(xyz), jnp.asarray(rot),
                                 jnp.asarray(pos), jnp.asarray(dirs), jcfg,
                                 NEAR, FAR)
    tres = TQP.query_points_pers(tgrid, t(xyz), t(rot), t(pos), t(dirs),
                                 tcfg, NEAR, FAR)
    _compare(jres, tres)
    # most rays aimed at a point find neighbours (the rotated camera sees
    # a few of those points outside its frustum)
    pm = n(tres.pnt_mask)
    assert pm[:12].any(axis=(1, 2)).sum() >= 10 and pm.sum() > 100
    # the placeholder of an empty slot is the ray's last candidate
    sm = n(tres.sample_mask)
    assert not sm.all()


@pytest.mark.parametrize("mode", ["passfunc", "gaussian", "uniform"])
def test_query_points_pers_jitter(mode):
    """Training: the candidates jittered by sample_jitter 0.3 and the
    shading points moved along z, each from JAX's own draws."""
    (jcfg, tcfg), xyz, (rot, pos), (jgrid, tgrid) = _setup(
        "rotated", sample_jitter=0.3)
    dirs = _rays(xyz, pos)
    key = jax.random.PRNGKey(5)
    R, D, SR = len(dirs), QCFG["z_depth_dim"], QCFG["SR"]
    noise = np.asarray(jax.random.uniform(key, (R, D)))
    jkey = jax.random.fold_in(key, 1)
    shp = np.asarray(jax.random.normal(jkey, (R, SR)) if mode == "gaussian"
                     else jax.random.uniform(jkey, (R, SR)))
    jres = JQP.query_points_pers(jgrid, jnp.asarray(xyz), jnp.asarray(rot),
                                 jnp.asarray(pos), jnp.asarray(dirs), jcfg,
                                 NEAR, FAR, key=key, train=True,
                                 shpnt_jitter=mode)
    tres = TQP.query_points_pers(tgrid, t(xyz), t(rot), t(pos), t(dirs),
                                 tcfg, NEAR, FAR, train=True,
                                 shpnt_jitter=mode, noise=t(noise),
                                 shpnt_noise=t(shp))
    _compare(jres, tres)
    still = TQP.query_points_pers(tgrid, t(xyz), t(rot), t(pos), t(dirs),
                                  tcfg, NEAR, FAR)
    moved = np.abs(n(tres.sample_loc_w) - n(still.sample_loc_w)).max()
    assert moved > 1e-3


def test_query_points_pers_generator_draws():
    """Without given noise, a generator draws both jitters; without one
    (JAX's key=None) neither moves anything."""
    (_, tcfg), xyz, (rot, pos), (_, tgrid) = _setup(sample_jitter=0.3)
    dirs = t(_rays(xyz, pos))
    args = (tgrid, t(xyz), t(rot), t(pos), dirs, tcfg, NEAR, FAR)
    plain = TQP.query_points_pers(*args)
    none = TQP.query_points_pers(*args, train=True, shpnt_jitter="gaussian")
    np.testing.assert_array_equal(n(none.sample_loc_w),
                                  n(plain.sample_loc_w))
    a, b = (TQP.query_points_pers(*args, train=True, shpnt_jitter="uniform",
                                  generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    np.testing.assert_array_equal(n(a.sample_loc_w), n(b.sample_loc_w))
    assert np.abs(n(a.sample_loc_w) - n(plain.sample_loc_w)).max() > 1e-3
    with pytest.raises(ValueError, match="shpnt_jitter"):
        TQP.query_points_pers(*args, shpnt_jitter="box")


def test_pers2w_and_raydir():
    rng = np.random.default_rng(2)
    rot, pos = _camera("rotated")
    xyz = _points(500, seed=3)
    pers = n(tcam.w2pers(t(xyz), t(rot), t(pos)))
    back = n(tcam.pers2w(t(pers), t(rot), t(pos)))
    np.testing.assert_allclose(back, xyz, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        back, np.asarray(jcam.pers2w(jnp.asarray(pers), jnp.asarray(rot),
                                     jnp.asarray(pos))), rtol=1e-6,
        atol=1e-7)
    # the written-out rotation of query_pers against w2pers
    np.testing.assert_allclose(n(TQP.to_pers(t(xyz), t(rot), t(pos))), pers,
                               rtol=1e-6, atol=1e-7)
    pix = rng.uniform(0, 64, (7, 9, 2)).astype(np.float32)
    for norm in (True, False):
        got = n(tcam.get_dtu_raydir(t(pix), t(INTR), t(rot), norm))
        want = np.asarray(jcam.get_dtu_raydir(jnp.asarray(pix),
                                              jnp.asarray(INTR),
                                              jnp.asarray(rot), norm))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
