"""The port's NeRF-synthetic data layer (data/nerf_synth.py and
data/synthetic.write_blender_scene) against the JAX package's
data/nerf_synth.py, bit for bit, on two small Blender-layout scenes in
tmp_path: one written by tools/make_fixture_scene.make_blender_fixture
(PIL), one by the port's write_blender_scene (io/png).  Both splits, the
random sampler's batches, the hybrid presets' nearest views, the images
and alpha mattes, the fused.ply cloud, the render path and the
intrinsics must be equal: the two packages run the same numpy arithmetic
on the same pixels.  A frame whose size differs from cfg.image_hw goes
through PIL's LANCZOS in both, and is equal too.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.data import nerf_synth as jnerf
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.data import nerf_synth as tnerf
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import png

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import make_fixture_scene as MFS  # noqa: E402

HW = (32, 32)
N_TRAIN, N_TEST = 8, 3


def _cfgs(preset, hw=HW):
    """(JAX, port) configs of `preset` at a small frame size; the hybrid
    preset's dilated sampler at tiny_test's patch layout (2 x 2 patches
    of 4 x 4), which a 32 x 32 frame holds."""
    out = []
    for pkg in (JC, TC):
        c = pkg.PRESETS[preset]().replace(image_hw=hw)
        if c.sampling.random_sample == "dilated":
            c = c.replace(sampling=dataclasses.replace(
                c.sampling, random_sample_size=8, dilation_patch_num=2,
                dilation_patch_size=4, edge_filter=0))
        out.append(c)
    return tuple(out)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("nerf")
    MFS.make_blender_fixture(str(base), "fixobj", N_TRAIN, N_TEST, *HW)
    tsyn.write_blender_scene(str(base), "portobj", N_TRAIN, N_TEST, HW,
                             num_points=3000)
    return str(base)


def _pair(root, scan, preset, split, hw=HW):
    jc, tc = _cfgs(preset, hw)
    return (jnerf.NerfSynthScene(root, scan, jc, split),
            tnerf.NerfSynthScene(root, scan, tc, split))


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


SCANS = ["fixobj", "portobj"]


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("scan", SCANS)
def test_scene_images_and_intrinsics_bitwise(scenes, scan, split):
    js, ts = _pair(scenes, scan, "fixture_nerf_points", split)
    assert len(js) == len(ts) == (N_TRAIN if split == "train" else N_TEST)
    _equal(js.intrinsic, ts.intrinsic, "intrinsic")
    assert js.focal == ts.focal
    _equal(js.train_c2w, ts.train_c2w, "train_c2w")
    _equal(js.train_dirs, ts.train_dirs, "train_dirs")
    for i in range(len(js)):
        _equal(js.image(i), ts.image(i), f"image {i}")
        _equal(js.c2w(i), ts.c2w(i), f"c2w {i}")
    for i in range(N_TRAIN):
        _equal(js.train_image(i), ts.train_image(i), f"train_image {i}")
        _equal(js.train_alpha(i), ts.train_alpha(i), f"train_alpha {i}")
    img = ts.image(0)
    # white background composited, the object in view
    assert img.max() == 1.0 and (img < 0.99).any()


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("preset", ["fixture_nerf_points",
                                    "fixture_nerf_hybrid"])
def test_get_batch_bitwise(scenes, scan, split, preset):
    """The random sampler (points) or the dilated one and the nearest
    views (hybrid) on the train split; every pixel on the test split."""
    js, ts = _pair(scenes, scan, preset, split)
    for idx in range(min(3, len(js))):
        jb = js.get_batch(idx, np.random.default_rng(idx + 5))
        tb = ts.get_batch(idx, np.random.default_rng(idx + 5))
        assert set(jb) == set(tb)
        for k in jb:
            if k == "vid":
                assert jb[k] == tb[k] == idx
            else:
                _equal(jb[k], tb[k], k)
        R = tb["raydir"].shape[0]
        if split == "test":
            assert R == HW[0] * HW[1]
        else:
            assert R == ts.cfg.sampling.rays_per_batch
        _equal(tb["bg_color"], np.ones(3, np.float32), "white bg")
        if preset.endswith("hybrid"):
            assert tb["images_nearest"].shape == (4,) + HW + (3,)
            if split == "train":
                assert idx not in tb["nearest_vids"]


@pytest.mark.parametrize("scan", SCANS)
def test_load_init_points_and_render_path_bitwise(scenes, scan):
    js, ts = _pair(scenes, scan, "fixture_nerf_points", "train")
    _equal(js.load_init_points(), ts.load_init_points(), "init points")
    assert len(ts.load_init_points()) > 1000
    for args in ((), (7, -20.0, 3.5)):
        jp, tp = js.render_path(*args), ts.render_path(*args)
        assert len(jp) == len(tp) == (args[0] if args else 40)
        for a, b in zip(jp, tp):
            _equal(a, b, "render path")


def test_pose_spherical_and_convention_bitwise():
    for th, ph, r in ((0.0, -30.0, 4.0), (123.0, 10.0, 2.5)):
        _equal(jnerf.pose_spherical(th, ph, r),
               tnerf.pose_spherical(th, ph, r), "pose_spherical")
    _equal(jnerf.BLENDER2OPENCV, tnerf.BLENDER2OPENCV, "BLENDER2OPENCV")


def test_resized_frames_go_through_pil_alike(scenes):
    """Frames at 32x32 read at 24x24: PIL's LANCZOS in both packages."""
    js, ts = _pair(scenes, "portobj", "fixture_nerf_points", "test",
                   hw=(24, 24))
    for i in range(N_TEST):
        _equal(js.image(i), ts.image(i), f"image {i}")
    _equal(js.train_alpha(0), ts.train_alpha(0), "alpha")
    _equal(js.intrinsic, ts.intrinsic, "intrinsic")


def test_background_from_config(scenes):
    """The frames are composited onto cfg.render.bg_color, the colour the
    batch carries to the renderer: on black bit for bit with the JAX
    package's bg="black", and on any other colour where alpha is 0."""
    jc, tc = _cfgs("fixture_nerf_points")
    js = jnerf.NerfSynthScene(scenes, "fixobj", jc, "test", bg="black")
    for bg in ((0.0, 0.0, 0.0), (0.25, 0.5, 0.75)):
        c = tc.replace(render=dataclasses.replace(tc.render, bg_color=bg))
        ts = tnerf.NerfSynthScene(scenes, "fixobj", c, "test")
        img = ts.image(1)
        a = ts._rgba(os.path.join(ts.root, ts.meta["frames"][1]["file_path"]
                                  + ".png"))[..., 3]
        assert 0 < (a == 0).sum() < a.size
        miss = img[a == 0]
        _equal(miss, np.broadcast_to(np.float32(bg), miss.shape),
               f"bg {bg} where alpha is 0")
        batch = ts.get_batch(1)
        _equal(batch["bg_color"], np.float32(bg), f"batch bg {bg}")
        if bg == (0.0, 0.0, 0.0):
            _equal(js.image(1), img, "black")


def test_write_blender_scene_layout(scenes):
    """The port's scene: RGBA PNGs whose alpha marks the object, lego's
    camera_angle_x, cameras at radius 4 looking at the origin, surface
    points inside +-1 m."""
    root = os.path.join(scenes, "portobj")
    rgba = png.read(os.path.join(root, "train", "r_0.png"))
    assert rgba.shape == HW + (4,) and rgba.dtype == np.uint8
    a = rgba[..., 3]
    assert set(np.unique(a)) == {0, 255} and 0.05 < (a > 0).mean() < 0.9
    assert (rgba[a == 0][:, :3] == 255).all()
    tc = _cfgs("fixture_nerf_points")[1]
    ts = tnerf.NerfSynthScene(scenes, "portobj", tc, "train")
    assert ts.meta["camera_angle_x"] == MFS_CAX
    pos = ts.train_c2w[:, :3, 3]
    np.testing.assert_allclose(np.linalg.norm(pos, axis=-1), 4.0,
                               rtol=1e-6)
    # each camera's z axis (OpenCV forward) points at the origin
    fwd = ts.train_c2w[:, :3, 2]
    np.testing.assert_allclose((fwd * -pos / 4.0).sum(-1), 1.0, atol=1e-5)
    xyz = ts.load_init_points()
    assert xyz.shape == (3000, 3) and np.abs(xyz).max() <= 1.0


MFS_CAX = 0.6911112070083618     # tools/make_fixture_scene.py's lego angle


def test_nerf_presets_run_the_scene_classes():
    from hybridneuralrendering_tpu_torch.cli import test as tcli
    from hybridneuralrendering_tpu_torch.data.scannet import ScannetScene
    for name in ("nerf_synth_points", "nerf_synth_hybrid",
                 "fixture_nerf_points", "fixture_nerf_hybrid"):
        assert tcli.scene_class(name) is tnerf.NerfSynthScene
    assert tcli.scene_class("scannet_full") is ScannetScene
    cfg = TC.nerf_train_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        TC.fixture_nerf_points())
