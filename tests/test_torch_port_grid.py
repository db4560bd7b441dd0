"""The port's voxel grid, query and point gather against the JAX package.

build_grid's tables come from a stable sort and integer arithmetic, so they
must be bitwise equal.  The K-NN reads the same buckets and computes the
same squared distances op by op, so with the same shading points its
distances are equal and its ids equal wherever a neighbour exists.
query_points draws its shading points from a cumsum of segment lengths,
which XLA sums in another order than torch: there the distances agree to
rtol 1e-5 and the ids must still be equal where pnt_mask holds.  The
per-voxel K-NN (supervoxel=False) is held to the same: its ids and masks
exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.ops import query as JQ
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.ops import query as TQ
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from torch_port_common import configs, make_batch, make_scene, n, t

GRID_TABLES = ("coor2occ", "occ_dilated", "occ_pnts", "occ_pnt_xyz",
               "occ_bucket", "occ_numpnts", "num_occ", "coor2node",
               "node_bucket", "num_nodes", "occ_bits")


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    jb, tb = make_batch(tc)
    return jc, tc, jpts, jgrid, tpts, tgrid, jb, tb


def test_geometry_equal(setup):
    _, _, _, jgrid, _, tgrid, _, _ = setup
    np.testing.assert_array_equal(n(tgrid.geom.origin),
                                  np.asarray(jgrid.geom.origin))
    np.testing.assert_array_equal(np.asarray(tgrid.geom.dims),
                                  np.asarray(jgrid.geom.dims))
    np.testing.assert_array_equal(n(tgrid.geom.vsize),
                                  np.asarray(jgrid.geom.vsize))


@pytest.mark.parametrize("table", GRID_TABLES)
def test_build_grid_tables_bitwise(setup, table):
    _, _, _, jgrid, _, tgrid, _, _ = setup
    ours = n(getattr(tgrid, table))
    ref = np.asarray(getattr(jgrid, table))
    assert ours.shape == ref.shape
    if ours.dtype.kind == "f":       # compare float tables bit for bit
        ours, ref = ours.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(ours, ref.astype(ours.dtype))


def test_build_grid_with_masked_points_and_overflow():
    """Dead points are left out; overfull voxels keep their first P."""
    jc, tc = configs()
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-0.3, 0.3, (900, 3)).astype(np.float32)
    mask = rng.random(900) < 0.8
    q_j = jc.querier.__class__(**{**jc.querier.__dict__, "P": 4, "Ps": 8,
                                  "max_o": 64, "max_nodes": 200})
    q_t = tc.querier.__class__(**{**tc.querier.__dict__, "P": 4, "Ps": 8,
                                  "max_o": 64, "max_nodes": 200})
    jgeom = JVG.compute_grid_geometry(xyz, mask, q_j)
    jgrid = JVG.build_grid_jit(jnp.asarray(xyz), jnp.asarray(mask), jgeom,
                               q_j)
    tgeom = TVG.compute_grid_geometry(xyz, mask, q_t, device="cpu")
    tgrid = TVG.build_grid(t(xyz), t(mask), tgeom, q_t)
    for table in GRID_TABLES:
        ours, ref = n(getattr(tgrid, table)), np.asarray(getattr(jgrid,
                                                                 table))
        if ours.dtype.kind == "f":
            ours, ref = ours.view(np.int32), ref.view(np.int32)
        np.testing.assert_array_equal(ours, ref.astype(ours.dtype), table)


def test_knn_equal_on_same_samples(setup):
    jc, tc, _, jgrid, _, tgrid, jb, tb = setup
    rng = np.random.default_rng(7)
    R, SR = 40, tc.querier.SR
    # shading points near the cloud, so most have neighbours
    a = np.asarray(jgrid.occ_pnt_xyz)[:R * SR, 0, :]
    loc = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    loc = loc.reshape(R, SR, 3)
    smask = np.ones((R, SR), bool)
    jd, ji = JQ.knn_over_grid(jgrid, jnp.asarray(loc), jnp.asarray(smask),
                              jc.querier)
    td, ti = TQ.knn_over_grid(tgrid, t(loc), t(smask), tc.querier)
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    found = np.asarray(jd) < 1e29
    assert found.mean() > 0.3
    np.testing.assert_array_equal(n(ti)[found], np.asarray(ji)[found])


def test_query_points(setup):
    jc, tc, jpts, jgrid, tpts, tgrid, jb, tb = setup
    near, far = tc.render.near_plane, tc.render.far_plane
    ref = JQ.query_points(jgrid, jpts.xyz, jb["campos"], jb["raydir"],
                          jc.querier, near, far)
    out = TQ.query_points(tgrid, tpts.xyz, tb["campos"], tb["raydir"],
                          tc.querier, near, far)
    for k in ("sample_mask", "ray_mask", "pnt_mask"):
        np.testing.assert_array_equal(n(getattr(out, k)),
                                      np.asarray(getattr(ref, k)), k)
    pm = np.asarray(ref.pnt_mask)
    assert pm.any() and n(out.ray_mask).mean() > 0.2
    np.testing.assert_array_equal(n(out.sample_pidx)[pm],
                                  np.asarray(ref.sample_pidx)[pm])
    np.testing.assert_array_equal(n(out.sample_pidx)[~pm], -1)
    np.testing.assert_allclose(n(out.sample_loc_w),
                               np.asarray(ref.sample_loc_w),
                               rtol=1e-5, atol=1e-6)


def _per_voxel(cfg):
    return dataclasses.replace(cfg, supervoxel=False)


def _near_samples(jgrid, tc, R=40, seed=7):
    """Shading points near the cloud [R, SR, 3], so most have
    neighbours."""
    rng = np.random.default_rng(seed)
    a = np.asarray(jgrid.occ_pnt_xyz)[:R * tc.querier.SR, 0, :]
    return (a + rng.normal(0, 0.05, a.shape)).astype(np.float32).reshape(
        R, tc.querier.SR, 3)


@pytest.mark.parametrize("node_bucket", ["supervoxel off", "no node table"])
def test_knn_per_voxel_equal_on_same_samples(setup, node_bucket):
    """The per-voxel K-NN, taken when supervoxel is off or the grid has no
    node table: distances and ids bit for bit with JAX's."""
    jc, tc, _, jgrid, _, tgrid, _, _ = setup
    loc = _near_samples(jgrid, tc)
    smask = np.ones(loc.shape[:2], bool)
    jq, tq = _per_voxel(jc.querier), _per_voxel(tc.querier)
    if node_bucket == "no node table":
        tq, tgrid = tc.querier, tgrid._replace(node_bucket=None)
    jd, ji = JQ.knn_over_grid(jgrid, jnp.asarray(loc), jnp.asarray(smask),
                              jq)
    td, ti = TQ.knn_over_grid(tgrid, t(loc), t(smask), tq)
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    assert (np.asarray(jd) < 1e29).mean() > 0.3


def test_query_points_per_voxel(setup):
    jc, tc, jpts, jgrid, tpts, tgrid, jb, tb = setup
    near, far = tc.render.near_plane, tc.render.far_plane
    ref = JQ.query_points(jgrid, jpts.xyz, jb["campos"], jb["raydir"],
                          _per_voxel(jc.querier), near, far)
    out = TQ.query_points(tgrid, tpts.xyz, tb["campos"], tb["raydir"],
                          _per_voxel(tc.querier), near, far)
    for k in ("sample_mask", "ray_mask", "pnt_mask"):
        np.testing.assert_array_equal(n(getattr(out, k)),
                                      np.asarray(getattr(ref, k)), k)
    pm = np.asarray(ref.pnt_mask)
    assert pm.any() and n(out.ray_mask).mean() > 0.2
    np.testing.assert_array_equal(n(out.sample_pidx),
                                  np.asarray(ref.sample_pidx))


def _fullest(tgrid, xyz, tc):
    """The most points any voxel, and any supervoxel node, would hold."""
    q = tc.querier
    coords = TVG.voxel_coords(t(xyz), tgrid.geom)
    vid = TVG.linearize(coords, tgrid.geom, q.grid_capacity)
    per_voxel = int(torch.bincount(vid).max())
    offs = torch.as_tensor(-TVG.neighbor_offsets(q.kernel_size))
    dvid = TVG.linearize(coords[None] + offs[:, None], tgrid.geom,
                         q.grid_capacity).reshape(-1)
    per_node = int(torch.bincount(dvid[dvid < q.grid_capacity]).max())
    return per_voxel, per_node


def test_per_voxel_and_supervoxel_give_the_same_neighbours(setup):
    """As JAX tests/test_query.py checks its own two paths: on a scene where
    no voxel holds more than P points and no node more than Ps, the two
    K-NN paths give the same masks and neighbour sets."""
    jc, tc, jpts, jgrid, tpts, tgrid, jb, tb = setup
    xyz = n(tpts.xyz)[n(tpts.mask)]
    per_voxel, per_node = _fullest(tgrid, xyz, tc)
    assert per_voxel <= tc.querier.P and per_node <= tc.querier.Ps
    near, far = tc.render.near_plane, tc.render.far_plane
    sv = TQ.query_points(tgrid, tpts.xyz, tb["campos"], tb["raydir"],
                         tc.querier, near, far)
    pv = TQ.query_points(tgrid, tpts.xyz, tb["campos"], tb["raydir"],
                         _per_voxel(tc.querier), near, far)
    for k in ("sample_mask", "ray_mask", "pnt_mask"):
        np.testing.assert_array_equal(n(getattr(pv, k)), n(getattr(sv, k)),
                                      k)
    assert n(sv.pnt_mask).any()
    np.testing.assert_array_equal(np.sort(n(pv.sample_pidx), axis=-1),
                                  np.sort(n(sv.sample_pidx), axis=-1))


@pytest.mark.parametrize("case", ["inside", "negative", "partly_past_end",
                                  "last_full", "sentinel"])
def test_window_gather_1d_edges_match_jax(case):
    """A window that starts below 0 or runs past the end, even by one
    entry, comes back filled throughout, as JAX's FILL_OR_DROP gather."""
    table = np.arange(10, dtype=np.int32) * 3 + 1
    starts = {"inside": [0, 4], "negative": [-1, -3], "partly_past_end":
              [8, 9], "last_full": [7, 7], "sentinel": [10, 10**6]}[case]
    starts = np.asarray(starts, np.int32).reshape(2, 1)
    want = np.asarray(JQ._window_gather_1d(jnp.asarray(table),
                                           jnp.asarray(starts), 3, -1))
    got = n(TQ._window_gather_1d(t(table), t(starts).long(), 3, -1))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 1, 3)
    if case in ("negative", "partly_past_end", "sentinel"):
        assert (got == -1).all()


def test_gather(setup):
    jc, tc, jpts, _, tpts, _, _, _ = setup
    rng = np.random.default_rng(8)
    pidx = rng.integers(-1, int(jpts.num_live), (5, 6, 4)).astype(np.int32)
    ref = jnpts.gather(jpts, jnp.asarray(pidx))
    out = tnpts.gather(tpts, t(pidx))
    for k in ("xyz", "embedding", "conf", "color", "dirs"):
        np.testing.assert_array_equal(n(getattr(out, k)),
                                      np.asarray(getattr(ref, k)), k)


def test_init_from_arrays_table_layout():
    jc, tc = configs()
    rng = np.random.default_rng(9)
    m, F = 20, tc.points.feature_dim
    arrs = dict(embedding=rng.normal(size=(m, F)), conf=rng.random((m, 1)),
                color=rng.random((m, 3)), dirs=rng.normal(size=(m, 3)))
    xyz = rng.normal(size=(m, 3)).astype(np.float32)
    ref = jnpts.init_from_arrays(xyz, jc.points, **arrs)
    out = tnpts.init_from_arrays(xyz, tc.points, device="cpu", **arrs)
    np.testing.assert_array_equal(n(out.table), np.asarray(ref.table))
    np.testing.assert_array_equal(n(out.mask), np.asarray(ref.mask))
    assert out.num_live == int(ref.num_live)
    assert out.table.shape[1] == tnpts.table_width(F) == 64
