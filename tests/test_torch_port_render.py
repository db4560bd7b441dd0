"""The port's eval render against the JAX package's eval_step, on tiny_test.

Both packages get the same numpy scene, rays, nearest views and weights
(through hybridneuralrendering_tpu_torch.io.from_jax).  At float32 the
stated tolerance is rtol 1e-4 / atol 1e-5: XLA fuses and reorders sums
(matmuls, the cumsum of segment lengths, FMA contraction), torch does not,
and the differences pass through a few MLP layers.  The bfloat16 case
(shading_dtype and pyramid_dtype bf16, the scannet_full setting) rounds at
other points in the two frameworks; a bf16 value carries 8 significant
bits (relative step 2**-8 = 0.4%); colours and opacities in [0, 1] must
agree to atol 5e-3, about one bf16 step near 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.data import synthetic as jsyn
from hybridneuralrendering_tpu.models import aggregator as jagg
from hybridneuralrendering_tpu.models import fusion as jfusion
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.models import fusion as tfusion
from hybridneuralrendering_tpu_torch.models import renderer as trenderer
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from torch_port_common import (configs, make_batch, make_params, make_scene,
                               n, t)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 5e-3
# lifts the random density head so that points, not the white background,
# make most of each colour
ALPHA_BIAS = 4.0
RENDER_OUTPUTS = ("coarse_raycolor", "coarse_point_opacity",
                  "coarse_is_background", "ray_mask", "ray_valid", "weight",
                  "blend_weight", "conf_coefficient", "queried_shading")


def _render_pair(**agg):
    jc, tc = configs(**agg)
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    jb, tb = make_batch(tc)
    jp, tp = make_params(jc, alpha_bias=ALPHA_BIAS)
    ref = jstep.eval_step(jp, jpts, jgrid, jb, jc)
    out = serve.eval_step(tp, tpts, tgrid, tb, tc)
    return ref, out


@pytest.fixture(scope="module")
def f32_pair():
    return _render_pair()


@pytest.mark.parametrize("key", RENDER_OUTPUTS)
def test_render_f32_matches_eval_step(f32_pair, key):
    ref, out = f32_pair
    np.testing.assert_allclose(n(out[key]), np.asarray(ref[key]), **F32)


def test_render_hits_the_scene(f32_pair):
    ref, out = f32_pair
    hit = n(out["ray_mask"])
    assert 0.2 < hit.mean() < 1.0
    assert np.isfinite(n(out["coarse_raycolor"])).all()


def test_render_bf16_chains():
    ref, out = _render_pair(shading_dtype="bfloat16",
                            pyramid_dtype="bfloat16")
    np.testing.assert_array_equal(n(out["ray_mask"]),
                                  np.asarray(ref["ray_mask"]))
    for k in ("coarse_raycolor", "coarse_point_opacity"):
        np.testing.assert_allclose(n(out[k]), np.asarray(ref[k]), rtol=0,
                                   atol=BF16_ATOL, err_msg=k)


def _agg_inputs(tc, seed=3):
    """Random neighbour sets with a third of the slots empty, plus a
    nearest-view stack whose reprojections partly fall off the image."""
    rng = np.random.default_rng(seed)
    R, SR, K = 12, tc.querier.SR, tc.querier.K
    V, (H, W) = tc.agg.use_nearest, tc.image_hw
    Fd = tc.points.feature_dim
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    loc_w = f(R, SR, 3)
    dirs = f(R, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(
        sampled_xyz=loc_w[:, :, None] + 0.05 * f(R, SR, K, 3),
        sampled_xyz_pers=f(R, SR, K, 3), sampled_embedding=f(R, SR, K, Fd),
        sampled_color=rng.random((R, SR, K, 3)).astype(np.float32),
        sampled_dir=f(R, SR, K, 3),
        sampled_conf=rng.uniform(-0.2, 1.2, (R, SR, K)).astype(np.float32),
        pnt_mask=rng.random((R, SR, K)) < 0.67,
        sample_loc=f(R, SR, 3), sample_loc_w=loc_w,
        sample_ray_dirs=np.broadcast_to(dirs[:, None], (R, SR, 3)).copy(),
        img_feat_n=f(V, H, W, tc.agg.aux_feature_channels),
        sample_loc_i_n=np.stack([rng.uniform(-10, W + 10, (V, R, SR)),
                                 rng.uniform(-10, H + 10, (V, R, SR))],
                                -1).astype(np.float32),
        delta_viewdir_n=f(V, R, SR, 3),
        frame_weight_n=rng.random(V).astype(np.float32))


def test_aggregator_apply():
    jc, tc = configs()
    jp, tp = make_params(jc)
    a = _agg_inputs(tc)
    vs = tc.querier.query_vsize
    ref = jax.jit(lambda p, kw: jagg.apply(p, jc.agg, vsize=vs, **kw))(
        jp["aggregator"], {k: jnp.asarray(v) for k, v in a.items()})
    out = tagg.apply(tp["aggregator"], tc.agg, vsize=vs,
                     **{k: t(v) for k, v in a.items()})
    for k in ("features", "ray_valid", "weight", "conf_coefficient"):
        np.testing.assert_allclose(n(getattr(out, k)),
                                   np.asarray(getattr(ref, k)), **F32,
                                   err_msg=k)


@pytest.mark.parametrize("downweight", [False, True])
def test_image_fusion(downweight):
    jc, tc = configs(downweight_blurry_feats=downweight)
    jp, tp = make_params(jc)
    a = _agg_inputs(tc, seed=4)
    cf = np.random.default_rng(5).normal(
        size=a["sample_loc"].shape[:2] + (tc.agg.shading_feature_num // 2,)
    ).astype(np.float32)
    keys = ("img_feat_n", "sample_loc_i_n", "delta_viewdir_n",
            "frame_weight_n")
    jfn = functools.partial(jfusion.image_fusion, cfg=jc.agg,
                            img_feat_staged=None, view_mask=None,
                            drop_mask=None, train=False)
    ref = jax.jit(lambda p, c, kw: jfn(p, color_feature=c, **kw))(
        jp["aggregator"], jnp.asarray(cf),
        {k: jnp.asarray(a[k]) for k in keys})
    out = tfusion.image_fusion(tp["aggregator"], tc.agg, t(cf),
                               *[t(a[k]) for k in keys])
    np.testing.assert_allclose(n(out), np.asarray(ref), **F32)
    mixed_ref = jfusion.mixup(jp["aggregator"], jc.agg, jnp.asarray(cf), ref)
    mixed = tfusion.mixup(tp["aggregator"], tc.agg, t(cf), out)
    np.testing.assert_allclose(n(mixed), np.asarray(mixed_ref), **F32)


def test_render_rays_chunks_equal_one_pass():
    jc, tc = configs()
    _, (tpts, tgrid) = make_scene(jc, tc)
    _, tb = make_batch(tc, num_rays=70)
    _, tp = make_params(jc)
    whole = serve.eval_step(tp, tpts, tgrid, tb, tc)
    tc16 = tc.replace(sampling=tc.sampling.__class__(eval_chunk_rays=16))
    out = serve.render_rays(tp, tpts, tgrid, tb, tc16)
    assert set(out) == set(serve.RAY_OUTPUTS)
    for k in serve.RAY_OUTPUTS:
        np.testing.assert_allclose(n(out[k]), n(whole[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_synthetic_data_matches_jax_generator():
    jc, tc = configs()
    jb = jsyn.make_synthetic_batch(jc, seed=1)
    tb = tsyn.batch_arrays(tc, seed=1)
    for k, v in jb.items():
        if k == "frame_weight":
            continue
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(v), k)
    jpts, _ = jsyn.make_synthetic_scene(jc, 600, seed=2)
    a = tsyn.scene_arrays(tc, 600, seed=2)
    for name in ("xyz", "conf", "color", "dirs"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jpts, name))[:600],
            np.asarray(a[name], np.float32), name)


@pytest.mark.parametrize("preset", ["tiny_test", "scannet_full",
                                    "fixture_nerf_points",
                                    "nerf_synth_hybrid"])
def test_init_params_shapes_match_jax(preset):
    from hybridneuralrendering_tpu import config as JC
    from hybridneuralrendering_tpu_torch import config as TC
    jc, tc = getattr(JC, preset)(), getattr(TC, preset)()
    shapes = jax.eval_shape(lambda k: jrenderer.init_params(k, jc),
                            jax.random.PRNGKey(0))
    ours = trenderer.init_params(tc, seed=0, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [(p, s.shape) for p, s in flat_ref] == \
        [(p, tuple(v.shape)) for p, v in flat_ours]


def test_from_jax_rejects_wrong_table_width():
    with pytest.raises(ValueError):
        from_jax.points_from_numpy(np.zeros((4, 40), np.float32),
                                   np.ones(4, bool), 8, device="cpu")


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    jc, tc = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        trenderer.init_params(tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.make_synthetic_batch(tc)
    xyz = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TVG.compute_grid_geometry(xyz, np.ones(2, bool), tc.querier)
