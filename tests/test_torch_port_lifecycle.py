"""The port's point lifecycle (prune, grow, the renderer's prob outputs,
train/lifecycle.py) and its multi-frame training step against the JAX
package, on the CPU.

Same numpy inputs and weights (through hybridneuralrendering_tpu_torch.io.
from_jax) go to both packages.  Tolerances:

- prune, grow, bloat_mask, RayMissTracker and holes_from_maps move or
  select values without arithmetic: bit for bit on the table, the mask and
  num_live, and exactly on the selected arrays.
- the prob outputs: the render's float32 tolerance, rtol 1e-4 / atol 1e-5
  (tests/test_torch_port_render.py).  A ray whose two largest opacities
  lie within that tolerance of each other may pick another max-opacity
  sample in the two packages; such rays are excluded from the prob keys
  and counted, and the count is held below a stated share.
- probe_frame: the same tolerance on every map, exact on the ray mask.
- probe_and_grow / prune_and_rebuild from one state: the same number of
  points added, the same grid ids and masks.  A candidate whose opacity
  lies within the render tolerance of prob_thresh could be taken by one
  package and not the other; the test counts them (1 of the scene's 3
  train frames' candidates, at most MAX_NEAR_THRESH allowed) and fails,
  naming that count, if the numbers added differ.
- train_step_multi at F = 2, uncached and cached: the tolerances of
  tests/test_torch_port_train.py's whole-step tests (loss items rtol 1e-4
  / atol 1e-6, gradients _close_grad, the state after _close_update).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.data import scannet as jscannet
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu.train import lifecycle as jlife
from hybridneuralrendering_tpu.train import pyramid_cache as jpc
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.data import scannet as tscannet
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.ops import scan as tscan
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.train import lifecycle as tlife
from hybridneuralrendering_tpu_torch.train import pyramid_cache as tpc
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from test_torch_port_train import (_close_grad, _close_update, _noise,
                                   _port_state, _train_setup)
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    configs, make_batch, make_params, make_scene, n, numpy_params,
    one_torch_thread, t, write_fake_scannet)

RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
# the share of rays whose two largest opacities are a tie within
# RENDER_TOL, above which the prob comparison would say little
MAX_TIE_SHARE = 0.05
GRID_KEYS = ("coor2occ", "occ_dilated", "occ_pnts", "occ_numpnts",
             "coor2node", "occ_bits")


# --------------------------------------------------------------- prune/grow

def _cloud(jc, seed, live_share):
    """A JAX cloud at tiny_test capacity (2,048) whose live slots are
    scattered: 1,596 points, then a conf prune leaves about live_share of
    them."""
    rng = np.random.default_rng(seed)
    a = tsyn.scene_arrays(jc, 1600, seed)
    conf = rng.uniform(0, 1, (len(a["xyz"]), 1))
    pts = jnpts.init_from_arrays(a["xyz"], jc.points, embedding=a["embedding"],
                                 conf=conf, color=a["color"], dirs=a["dirs"])
    return jnpts.prune(pts, 1.0 - live_share)


def _port(jpts, tc):
    return from_jax.points_from_numpy(
        np.asarray(jpts.table), np.asarray(jpts.mask), tc.points.feature_dim,
        trainable=jpts.trainable, device="cpu")


def _same_points(tp, jp):
    assert np.array_equal(n(tp.table), np.asarray(jp.table))
    assert np.array_equal(n(tp.mask), np.asarray(jp.mask))
    assert tp.num_live == int(jp.num_live) == int(np.asarray(jp.mask).sum())


@pytest.mark.parametrize("thresh", [-1.0, 0.3, 0.7, 2.0])
def test_prune_bitwise(thresh):
    jc, tc = configs()
    jp = _cloud(jc, 0, 1.0)
    tp = _port(jp, tc)
    table0 = tp.table.clone()
    got, want = tnpts.prune(tp, thresh), jnpts.prune(jp, thresh)
    _same_points(got, want)
    assert torch.equal(tp.table, table0) and tp.num_live == 1596


# name: (live share of the 1,596 points (or "full" capacity), new points M,
#        share of them masked in)
GROW_CASES = {
    "more_new_than_free": (0.5, 2000, 1.0),
    "partial_new_mask": (0.6, 300, 0.5),
    "fills_exactly": (0.75, 848, 1.0),
    "no_free_slot": ("full", 50, 1.0),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_bitwise(case):
    live, M, share = GROW_CASES[case]
    jc, tc = configs()
    if live == "full":
        a = tsyn.scene_arrays(jc, jc.points.num_points, 3)
        jp = jnpts.init_from_arrays(a["xyz"], jc.points,
                                    embedding=a["embedding"])
    else:
        jp = _cloud(jc, 1, live)
        if case == "fills_exactly":
            # M masked-in points for exactly the free slots
            M = jc.points.num_points - int(jp.num_live)
    rng = np.random.default_rng(7)
    F = jc.points.feature_dim
    new = dict(xyz=rng.normal(size=(M, 3)), emb=rng.normal(size=(M, F)),
               conf=rng.uniform(0, 1, (M, 1)), color=rng.uniform(0, 1, (M, 3)),
               dirs=rng.normal(size=(M, 3)))
    new = {k: v.astype(np.float32) for k, v in new.items()}
    mask = rng.uniform(0, 1, M) < share
    order = ("xyz", "emb", "conf", "color", "dirs")
    want = jnpts.grow(jp, *(jnp.asarray(new[k]) for k in order),
                      jnp.asarray(mask))
    tp = _port(jp, tc)
    before = (tp.table.clone(), tp.mask.clone(), tp.num_live)
    scans = tscan.cumsum_rows.launches
    got = tnpts.grow(tp, *(t(new[k]) for k in order), t(mask))
    _same_points(got, want)
    # the input is untouched; on the CPU no kernel launches
    assert torch.equal(tp.table, before[0]) and torch.equal(tp.mask, before[1])
    assert tp.num_live == before[2]
    assert tscan.cumsum_rows.launches == scans
    free = jc.points.num_points - before[2]
    assert got.num_live == before[2] + min(free, int(mask.sum()))


def test_grow_ranks_through_cumsum_rows(monkeypatch):
    """grow ranks the new points and the free slots with the row scan."""
    jc, tc = configs()
    tp = _port(_cloud(jc, 2, 0.5), tc)
    calls = []
    real = tscan.cumsum_rows
    monkeypatch.setattr(tnpts, "cumsum_rows",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    M = 40
    z = torch.zeros(M, 3)
    tnpts.grow(tp, z, torch.zeros(M, 8), torch.zeros(M, 1), z, z,
               torch.ones(M, dtype=torch.bool))
    assert sorted(calls) == sorted([(M,), (tc.points.num_points,)])


# ------------------------------------------------------------- prob outputs

def _ties(opacity, tol=RENDER_TOL):
    """Rays whose two largest opacities lie within tol of each other, but
    not those whose opacities are all 0 (a miss ray's, 0 in both packages:
    the test checks it; the first maximum is then sample 0 in both)."""
    top2 = np.sort(opacity, axis=-1)[:, -2:]
    return (np.abs(top2[:, 1] - top2[:, 0]) <= tol["atol"] + tol["rtol"] *
            np.abs(top2[:, 1])) & (top2[:, 1] > 0)


def _prob_renders(num_rays=384):
    jc, tc = configs()
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    jp, tp = make_params(jc, alpha_bias=3.0)
    jb, tb = make_batch(tc, num_rays=num_rays)
    want = jstep.eval_step(jp, jpts, jgrid, jb, jc, prob=True)
    got = serve.eval_step(tp, tpts, tgrid, tb, tc, prob=True)
    return {k: np.asarray(v) for k, v in want.items()}, \
        {k: n(v) for k, v in got.items()}


def test_prob_outputs_match_jax():
    want, got = _prob_renders()
    assert set(serve.PROB_OUTPUTS) <= set(got) and \
        set(serve.PROB_OUTPUTS) <= set(want)
    ties = _ties(want["coarse_point_opacity"])
    hit = want["ray_mask"]
    dark = want["coarse_point_opacity"].max(axis=-1) == 0
    assert dark.any() and not got["coarse_point_opacity"][dark].any()
    assert np.array_equal(got["ray_mask"], hit) and hit.mean() > 0.5
    assert ties.mean() <= MAX_TIE_SHARE, ties.mean()
    keep = ~ties
    for k in serve.PROB_OUTPUTS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k][keep], want[k][keep],
                                   err_msg=k, **RENDER_TOL)
    assert np.abs(want["shading_avg_embedding"][keep & hit]).max() > 0


def test_prob_argmax_takes_the_first_maximum():
    op = torch.tensor([[0.1, 0.5, 0.5, 0.2], [0.3, 0.3, 0.3, 0.3],
                       [0.0, 0.0, 0.0, 0.9]])
    R, SR, K = 3, 4, 2
    sampled = tnpts.SampledPoints(
        xyz=torch.zeros(R, SR, K, 3), embedding=torch.zeros(R, SR, K, 2),
        conf=torch.zeros(R, SR, K), color=torch.zeros(R, SR, K, 3),
        dirs=torch.zeros(R, SR, K, 3))
    loc = torch.arange(R * SR * 3, dtype=torch.float32).reshape(R, SR, 3)
    from hybridneuralrendering_tpu_torch.models import renderer
    out = renderer.prob_outputs(op, loc, sampled, torch.zeros(R, SR, K))
    idx = np.asarray(jnp.argmax(jnp.asarray(n(op)), axis=-1))
    assert idx.tolist() == [1, 0, 3]
    assert torch.equal(out["ray_max_sample_loc_w"],
                       loc[torch.arange(R), torch.as_tensor(idx.copy())])


def test_render_rays_prob_passes_through():
    jc, tc = configs()
    (_, _), (tpts, tgrid) = make_scene(jc, tc)
    _, tp = make_params(jc, alpha_bias=3.0)
    _, tb = make_batch(tc, num_rays=200)
    tc_small = tc.replace(sampling=dataclasses.replace(
        tc.sampling, eval_chunk_rays=64))
    whole = serve.eval_step(tp, tpts, tgrid, tb, tc, prob=True)
    chunks = serve.render_rays(tp, tpts, tgrid, tb, tc_small, prob=True)
    plain = serve.render_rays(tp, tpts, tgrid, tb, tc_small)
    assert set(chunks) == set(serve.RAY_OUTPUTS + serve.PROB_OUTPUTS)
    assert set(plain) == set(serve.RAY_OUTPUTS)
    for k in chunks:
        torch.testing.assert_close(chunks[k], whole[k], rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------- tracker, masks, holes

def test_ray_miss_tracker_matches_jax():
    rng = np.random.default_rng(4)
    jt, tt = jlife.RayMissTracker(top_k=4), tlife.RayMissTracker(top_k=4)
    for _ in range(40):
        fi, loss = int(rng.integers(9)), float(rng.choice(
            [0.0, 5e-6, rng.uniform(0, 1)]))
        jt.update(fi, loss)
        tt.update(fi, loss)
        assert tt.top_ids() == jt.top_ids()
    assert len(tt.top_ids()) == 4 and tt.loss == jt.loss
    jt.reset()
    tt.reset()
    assert tt.top_ids() == jt.top_ids() == []


@pytest.mark.parametrize("radius", [1, 2])
def test_bloat_mask_matches_jax(radius):
    rng = np.random.default_rng(radius)
    mask = rng.uniform(0, 1, (23, 31)) < 0.05
    mask[0, 0] = mask[-1, -1] = True
    got = tlife.bloat_mask(mask, radius)
    assert np.array_equal(got, jlife.bloat_mask(mask, radius))
    assert got.sum() > mask.sum()


def _random_maps(H=24, W=32, F=8, seed=0):
    rng = np.random.default_rng(seed)
    hit = rng.uniform(0, 1, (H, W)) < 0.8
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt[:3] = 1.0                           # background-coloured rows
    return {
        "gt_image": gt,
        "ray_mask": hit[..., None],
        "coarse_raycolor": (gt + rng.normal(0, 0.08, gt.shape)).astype(
            np.float32),
        "ray_max_far_dist": rng.uniform(0, 0.2, (H, W, 1)).astype(np.float32),
        "ray_max_shading_opacity": rng.uniform(0, 1, (H, W, 1)).astype(
            np.float32),
        "ray_max_sample_loc_w": rng.normal(size=(H, W, 3)).astype(np.float32),
        "shading_avg_embedding": rng.normal(size=(H, W, F)).astype(np.float32),
        "shading_avg_color": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "shading_avg_dir": rng.normal(size=(H, W, 3)).astype(np.float32),
        "shading_avg_conf": rng.uniform(0, 1, (H, W, 1)).astype(np.float32),
    }


@pytest.mark.parametrize("far_thresh", [-1.0, 0.1])
def test_holes_from_maps_matches_jax(far_thresh):
    jc, tc = configs()
    probe = dict(far_thresh=far_thresh, prob_thresh=0.5)
    jc = jc.replace(probe=dataclasses.replace(jc.probe, **probe))
    tc = tc.replace(probe=dataclasses.replace(tc.probe, **probe))
    maps = _random_maps()
    bg = np.ones(3, np.float32)
    want = jlife.holes_from_maps(maps, bg, jc)
    got = tlife.holes_from_maps(maps, bg, tc)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) > 10


# --------------------------------------------------- probe on a fake scene

def _wall_points(n, seed=0):
    """A wall at z = 1.5 in front of the fake scene's cameras with a
    hole at x, y in [-0.3, 0.7] x [-0.35, 0.35], wider than the querier's
    reach (a voxel of 0.1 m and its neighbours)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.0, 1.6, n), rng.uniform(-0.8, 0.8, n),
                    1.5 + rng.normal(0, 0.01, n)], -1).astype(np.float32)
    hole = ((xyz[:, 0] > -0.3) & (xyz[:, 0] < 0.7) & (xyz[:, 1] > -0.35)
            & (xyz[:, 1] < 0.35))
    xyz = xyz[~hole]
    m = len(xyz)
    return dict(xyz=xyz, conf=rng.uniform(0.5, 1.0, (m, 1)),
                color=rng.uniform(0, 1, (m, 3)), dirs=rng.normal(size=(m, 3)),
                embedding=rng.standard_normal((m, 8)) * 0.1)


PROB_THRESH = 0.18
# candidate pixels within the render tolerance of PROB_THRESH that the
# grow comparison tolerates (a count stated in its test)
MAX_NEAR_THRESH = 3


@pytest.fixture(scope="module")
def probe_scene(tmp_path_factory):
    """Both packages' dataset (the fake scene's train split), points with a
    hole, grid and parameters, with prob_thresh lowered to PROB_THRESH
    (the random weights' max opacities here lie in 0.14-0.25)."""
    root, scan = write_fake_scannet(tmp_path_factory.mktemp("probe"),
                                    n_frames=12, ext="png")
    jc, tc = configs()
    probe = dict(prob_thresh=PROB_THRESH, prune_thresh=0.7)
    # a frame's 3,072 rays in 3 chunks
    jc = jc.replace(probe=dataclasses.replace(jc.probe, **probe),
                    sampling=dataclasses.replace(jc.sampling,
                                                 eval_chunk_rays=1024))
    tc = tc.replace(probe=dataclasses.replace(tc.probe, **probe),
                    sampling=dataclasses.replace(tc.sampling,
                                                 eval_chunk_rays=1024))
    a = _wall_points(1400)
    jpts = jnpts.init_from_arrays(a["xyz"], jc.points,
                                  embedding=a["embedding"], conf=a["conf"],
                                  color=a["color"], dirs=a["dirs"])
    jgeom = JVG.compute_grid_geometry(a["xyz"], np.ones(len(a["xyz"]), bool),
                                      jc.querier)
    jgrid = JVG.build_grid_jit(jpts.xyz, jpts.mask, jgeom, jc.querier)
    tpts = _port(jpts, tc)
    tgrid = TVG.grid_of(tpts.xyz, tpts.mask, tc.querier)
    tree = numpy_params(lambda k: jrenderer.init_params(k, jc))
    tree["aggregator"]["alpha"][-1]["b"] += np.float32(3.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_jax.params_from_numpy(tree, device="cpu")
    jds = jscannet.ScannetScene(root, scan, jc, "train")
    tds = tscannet.ScannetScene(root, scan, tc, "train")
    return dict(jc=jc, tc=tc, j=(jp, jpts, jgrid, jds),
                t=(tp, tpts, tgrid, tds))


@pytest.mark.parametrize("frame", [0, 2])
def test_probe_frame_matches_jax(probe_scene, frame):
    s = probe_scene
    want = jlife.probe_frame(*s["j"][:3], s["j"][3], frame, s["jc"])
    got = tlife.probe_frame(*s["t"][:3], s["t"][3], frame, s["tc"])
    assert set(got) == set(want)
    hit = want["ray_mask"][..., 0]
    assert np.array_equal(got["ray_mask"], want["ray_mask"])
    assert 0.2 < hit.mean() < 0.98            # the hole and the edges miss
    np.testing.assert_array_equal(got["gt_image"], want["gt_image"])
    for k in tlife.PROBE_KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **RENDER_TOL)


def _near_thresh(maps, cfg):
    """Candidate pixels (hit rays next to a miss, as holes_from_maps picks
    them before its opacity test) whose opacity lies within RENDER_TOL of
    prob_thresh."""
    thresh = cfg.probe.prob_thresh
    hit = maps["ray_mask"][..., 0] > 0
    bg = np.asarray(cfg.render.bg_color, np.float32)
    miss = ~hit & (np.linalg.norm(maps["gt_image"] - bg, axis=-1) > 0.002)
    op = maps["ray_max_shading_opacity"][..., 0]
    near = np.abs(op - thresh) <= RENDER_TOL["atol"] + RENDER_TOL["rtol"] * \
        thresh
    return int((near & hit & tlife.bloat_mask(miss, 1)).sum())


def test_probe_and_grow_then_prune_match_jax(probe_scene):
    s = probe_scene
    jp, jpts, jgrid, jds = s["j"]
    tp, tpts, tgrid, tds = s["t"]
    # candidates within the tolerance of prob_thresh on the train frames
    # (1 on this scene): the counts may differ by at most these
    near = sum(_near_thresh(tlife.probe_frame(tp, tpts, tgrid, tds, fi,
                                              s["tc"]), s["tc"])
               for fi in range(len(tds)))
    assert near <= MAX_NEAR_THRESH
    jnew, jg, jn = jlife.probe_and_grow(jp, jpts, jgrid, jds, s["jc"],
                                        max_frames=2,
                                        rng=np.random.default_rng(5))
    tnew, tg, tn = tlife.probe_and_grow(tp, tpts, tgrid, tds, s["tc"],
                                        max_frames=2,
                                        rng=np.random.default_rng(5))
    assert abs(tn - jn) <= near and tn > 20
    if tn != jn:
        pytest.fail(f"{tn} points grown, JAX {jn}: {near} candidates lie "
                    f"within tolerance of prob_thresh")
    assert tnew.num_live == int(jnew.num_live) == tpts.num_live + tn
    assert np.array_equal(n(tnew.mask), np.asarray(jnew.mask))
    # the grown rows: xyz and attributes from the render, within its
    # tolerance; the old rows untouched
    np.testing.assert_allclose(n(tnew.table), np.asarray(jnew.table),
                               **RENDER_TOL)
    old = n(tpts.mask)
    assert np.array_equal(n(tnew.table)[old], n(tpts.table)[old])
    for k in GRID_KEYS:
        assert np.array_equal(n(getattr(tg, k)), np.asarray(getattr(jg, k))), k
    # pruning the grown points (conf * prob_mul <= 0.4 < 0.7) from one
    # state carried across: equal bit for bit
    tcarried = _port(jnew, s["tc"])
    tpr, tg2 = tlife.prune_and_rebuild(tcarried, s["tc"])
    jpr, jg2 = jlife.prune_and_rebuild(jnew, s["jc"])
    _same_points(tpr, jpr)
    assert tpr.num_live < tcarried.num_live - jn + 1
    for k in GRID_KEYS:
        assert np.array_equal(n(getattr(tg2, k)),
                              np.asarray(getattr(jg2, k))), k


def test_probe_and_grow_with_tier_override_and_tracker(probe_scene):
    """A tier's query_size override probes through a grid of its own; with
    a tracker the frames are its top ids, and it is reset after growth."""
    s = probe_scene
    jp, jpts, jgrid, jds = s["j"]
    tp, tpts, tgrid, tds = s["t"]
    trackers = []
    for life in (jlife, tlife):
        tr = life.RayMissTracker()
        tr.update(1, 0.5)
        tr.update(0, 1e-7)                    # under the 1e-5 floor
        trackers.append(tr)
    jnew, jg, jn = jlife.probe_and_grow(jp, jpts, jgrid, jds, s["jc"],
                                        tracker=trackers[0],
                                        query_size_override=(1, 1, 1))
    tnew, tg, tn = tlife.probe_and_grow(tp, tpts, tgrid, tds, s["tc"],
                                        tracker=trackers[1],
                                        query_size_override=(1, 1, 1))
    assert tn == jn > 0
    assert np.array_equal(n(tnew.mask), np.asarray(jnew.mask))
    assert trackers[1].loss == trackers[0].loss == {}
    for k in GRID_KEYS:
        assert np.array_equal(n(getattr(tg, k)), np.asarray(getattr(jg, k))), k
    # nothing to grow: the same points and grid come back
    empty = tlife.RayMissTracker()
    same = tlife.probe_and_grow(tp, tpts, tgrid, tds, s["tc"], tracker=empty)
    assert same[0] is tpts and same[1] is tgrid and same[2] == 0


# ------------------------------------------------------- train_step_multi

def _frames(tc, seeds=(1, 2)):
    out = []
    for seed in seeds:
        a = tsyn.batch_arrays(tc, seed=seed)
        a["frame_weight"] = np.float32(0.7 + 0.1 * seed)
        out.append(a)
    return out


@pytest.fixture(scope="module", params=["uncached", "cached"])
def multi_step(request):
    """Both packages from one state through one train_step_multi of F = 2
    frames with the same per-frame noise (JAX's jax.random.split draws).
    JAX's gradients are read from its first moment after the step from
    zero moments, (1 - beta1) * g."""
    cached = request.param == "cached"
    jc, tc, jst, jgrid, _, tgrid, _, bank = _train_setup()
    frames = _frames(tc)
    jbs = jstep.stack_batches([{k: jnp.asarray(v) for k, v in f.items()}
                               for f in frames])
    tbs = tstep.stack_batches([{k: t(v) for k, v in f.items()}
                               for f in frames])
    tst = _port_state(jst, tc)
    before = _port_state(jst, tc)
    jstaged = tstaged = None
    if cached:
        jcache = jpc.PyramidCache(jc, dtype=jnp.float32)
        tcache = tpc.PyramidCache(tc, dtype=torch.float32)
        V = tc.agg.use_nearest
        js = [jcache.get_stack(jst.params, jbs["images_nearest"][f],
                               range(10 * f, 10 * f + V)) for f in range(2)]
        ts_ = [tcache.get_stack(tst.params, tbs["images_nearest"][f],
                                range(10 * f, 10 * f + V)) for f in range(2)]
        jstaged = (jbs["images_nearest"],
                   tuple(jnp.stack([s[j] for s in js]) for j in range(3)))
        tstaged = (tbs["images_nearest"],
                   tuple(torch.stack([s[j] for s in ts_]) for j in range(3)))
    key = jax.random.PRNGKey(41)
    noise = torch.stack([t(_noise(k, tc)) for k in jax.random.split(key, 2)])
    titems, tg_net, tg_table = tstep.multi_loss_and_grads(
        tst, tgrid, tbs, t(bank), tc, noise=noise, img_feat_staged=tstaged)
    jst, jitems = jstep.train_step_multi(jst, jgrid, jbs, key,
                                         jnp.asarray(bank), jc, jstaged)
    c1 = 1.0 - jc.optim.beta1
    jg_net = jax.tree_util.tree_map(lambda m: np.asarray(m) / c1,
                                    jst.opt_state_net[0].mu)
    jg_table = np.asarray(jst.opt_state_pts[0].mu["table"]) / c1
    tst, items2 = tstep.train_step_multi(tst, tgrid, tbs, t(bank), tc,
                                         noise=noise, img_feat_staged=tstaged)
    # the mean of two single-frame steps' gradients, for the port alone
    singles = [tstep.loss_and_grads(
        _port_state_like(before), tgrid, {k: v[f] for k, v in tbs.items()},
        t(bank), tc, noise=noise[f], img_feat_staged=None if not cached else
        (tstaged[0][f], tuple(s[f] for s in tstaged[1]))) for f in range(2)]
    return dict(tc=tc, cached=cached, jitems=jitems, titems=titems,
                items2=items2, jg_net=jg_net, tg_net=tg_net,
                jg_table=jg_table, tg_table=tg_table, before=before,
                jst=_port_state(jst, tc), tst=tst, singles=singles)


def _port_state_like(st):
    return tstate.TrainState(
        step=st.step, params=tstate.tree_map(torch.clone, st.params),
        points=dataclasses.replace(st.points, table=st.points.table.clone()),
        opt_net=st.opt_net, opt_pts=st.opt_pts)


def test_multi_step_loss_items(multi_step):
    s = multi_step
    assert set(s["titems"]) == set(s["jitems"]) == set(s["items2"])
    assert "ray_hit_frac" not in s["titems"]
    for k, v in s["jitems"].items():
        np.testing.assert_allclose(n(s["titems"][k]), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        assert float(s["items2"][k]) == float(s["titems"][k])
    # the items are the frames' means
    for k, v in s["titems"].items():
        mean = (float(s["singles"][0][0][k])
                + float(s["singles"][1][0][k])) / 2
        assert float(v) == pytest.approx(mean, rel=1e-6, abs=1e-7), k


def test_multi_step_gradients(multi_step):
    s = multi_step
    jl = jax.tree_util.tree_leaves(s["jg_net"])
    tl = tstate.tree_leaves(s["tg_net"])
    assert len(jl) == len(tl) > 20
    for got, want in zip(tl, jl):
        _close_grad(got, want)
    _close_grad(s["tg_table"], s["jg_table"])
    # and the mean of the two frames' own gradients
    mean_table = (s["singles"][0][2] + s["singles"][1][2]) / 2
    _close_grad(s["tg_table"], n(mean_table))
    for got, a, b in zip(tl, tstate.tree_leaves(s["singles"][0][1]),
                         tstate.tree_leaves(s["singles"][1][1])):
        _close_grad(got, n((a + b) / 2))
    pyr = tstate.tree_leaves(s["tg_net"]["aggregator"]["pyramid"])
    assert any(bool(g.any()) for g in pyr) != s["cached"]


def test_multi_step_state_after(multi_step):
    s = multi_step
    got, want, before = s["tst"], s["jst"], s["before"]
    assert got.step == want.step == 1
    assert got.opt_net.count == got.opt_pts.count == 1
    o = s["tc"].optim
    _close_grad(got.opt_pts.mu, want.opt_pts.mu)
    _close_update(got.points.table, n(want.points.table),
                  n(before.points.table), n(s["jg_table"]), o.plr)
    for gp, wp, bp, g in zip(tstate.tree_leaves(got.params),
                             tstate.tree_leaves(want.params),
                             tstate.tree_leaves(before.params),
                             jax.tree_util.tree_leaves(s["jg_net"])):
        _close_update(gp, n(wp), n(bp), g, o.lr)


def test_stack_batches_matches_jax():
    tc = configs()[1]
    frames = _frames(tc)
    want = jstep.stack_batches(frames)
    got = tstep.stack_batches(frames)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        assert np.array_equal(got[k], np.asarray(want[k])), k
    # a key holding a tensor stacks as a tensor on its device
    mixed = [dict(f, images_nearest=t(f["images_nearest"])) if i == 0 else f
             for i, f in enumerate(frames)]
    st = tstep.stack_batches(mixed)
    assert torch.is_tensor(st["images_nearest"])
    assert np.array_equal(n(st["images_nearest"]), want["images_nearest"])


def test_maybe_add_bg_ray():
    tc = configs()[1]
    batch = {"raydir": np.zeros((4, 3)), "images_nearest": np.zeros(1),
             "plane_pnt": np.zeros(3)}
    assert tstep.maybe_add_bg_ray(batch, None, tc) is batch
    plane = tc.replace(render=dataclasses.replace(tc.render,
                                                  bgmodel="img_plane"))
    no_keys = {"raydir": np.zeros((4, 3))}
    assert tstep.maybe_add_bg_ray(no_keys, None, plane) is no_keys
    # with the plane keys and the views: JAX's bg_ray (ported with ROADMAP
    # Queue 1 item 10; more cases in tests/test_torch_port_knobs.py)
    jc = configs()[0]
    jplane = jc.replace(render=dataclasses.replace(jc.render,
                                                   bgmodel="img_plane"))
    (jpts, _), (tpts, _) = make_scene(jc, tc)
    b = tsyn.batch_arrays(tc, seed=2, num_rays=64)
    b["images_nearest"][:] = 0.5
    b.update(plane_pnt=np.array([0.0, 0.0, 2.5], np.float32),
             plane_normal=np.array([0.0, 0.0, 1.0], np.float32),
             plane_color=np.array([0.5, 0.5, 0.5], np.float32))
    want = jstep.maybe_add_bg_ray(b, jpts, jplane)
    got = tstep.maybe_add_bg_ray(b, tpts, plane)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(n(got["bg_ray"]), np.asarray(want["bg_ray"]),
                               rtol=1e-5, atol=1e-5)
