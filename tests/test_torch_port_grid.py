"""The port's voxel grid, query and point gather against the JAX package.

build_grid's tables come from a stable sort and integer arithmetic, so they
must be bitwise equal.  The K-NN reads the same buckets and computes the
same squared distances op by op, so with the same shading points its
distances are equal and its ids equal wherever a neighbour exists.
query_points draws its shading points from a cumsum of segment lengths,
which XLA sums in another order than torch: there the distances agree to
rtol 1e-5 and the ids must still be equal where pnt_mask holds.
"""

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


def test_knn_per_voxel_not_ported(setup):
    _, tc, _, _, _, tgrid, _, _ = setup
    with pytest.raises(NotImplementedError):
        TQ.knn_over_grid(tgrid._replace(node_bucket=None),
                         torch.zeros(1, 2, 3), torch.ones(1, 2, dtype=bool),
                         tc.querier)


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
