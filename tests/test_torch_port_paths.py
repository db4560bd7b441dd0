"""The camera-path and preview drivers of the port against the JAX
package's: data/paths.gen_render_path, data.create_dataset,
Visualizer.gen_video, cli/render_vid (PathView, render_pose_path,
scene_path_poses, main) and cli/visualize, on a fake ScanNet scene
(tests/torch_port_common.write_fake_scannet) and a Blender-layout scene
(tools/make_fixture_scene.make_blender_fixture), each with one JAX-saved
checkpoint.

Tolerances:
- path poses: bit for bit (the same numpy arithmetic);
- PathView batches: equal arrays (both build them in numpy);
- rendered frames: the two packages' renders differ by float32 summation
  order, so the 8-bit PNGs differ by at most 1 level
  (tests/test_torch_port_eval_cli.py); file names equal; log lines equal
  up to the timestamp, with a PSNR line's value within 0.01 dB (its last
  printed digit) and the video line's path equal up to the checkpoints
  dir;
- the videos: GIFs of the PNGs (ffmpeg is absent, so no mp4), decoded
  frame for frame equal to the JAX CLI's where the two PNGs are equal (a
  GIF's palette quantises the colours, so a frame is not its PNG).
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import render_vid as jvid
from hybridneuralrendering_tpu.cli import visualize as jvis
from hybridneuralrendering_tpu.data import create_dataset as jcreate
from hybridneuralrendering_tpu.data import paths as jpaths
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import state as jstate
from hybridneuralrendering_tpu.utils.visualizer import Visualizer as JVis
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.cli import render_vid as tvid
from hybridneuralrendering_tpu_torch.cli import visualize as tvis
from hybridneuralrendering_tpu_torch.data import create_dataset as tcreate
from hybridneuralrendering_tpu_torch.data import paths as tpaths
from hybridneuralrendering_tpu_torch.data.nerf_synth import NerfSynthScene
from hybridneuralrendering_tpu_torch.data.scannet import ScannetScene
from hybridneuralrendering_tpu_torch.io import png
from hybridneuralrendering_tpu_torch.utils.visualizer import Visualizer
from test_torch_port_eval_cli import _log_lines, _wall_points
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    numpy_params, one_torch_thread, write_fake_scannet)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_POSES = os.path.join(ROOT, ".fixture/roomsim/exported/pose")
NERF_PRESET, NERF_SCAN = "nerf_vtest", "vidobj"
SCANNET_SCAN = "scene_vid"
CHUNK = 1024


# ------------------------------------------------------- gen_render_path

def _rot(deg):
    return jpaths._matrix_from_euler_xyz(np.asarray(deg, np.float64))


def _poses(rots, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for r in rots:
        c2w = np.eye(4)
        c2w[:3, :3] = r
        c2w[:3, 3] = rng.normal(size=3)
        out.append(c2w)
    return np.stack(out).astype(np.float32)


def _fixture_keys():
    if not os.path.isdir(FIXTURE_POSES):
        pytest.skip(".fixture/roomsim is not in this checkout")
    vids = sorted(int(f[:-4]) for f in os.listdir(FIXTURE_POSES))
    return np.stack([np.loadtxt(os.path.join(FIXTURE_POSES, f"{v}.txt"))
                     .astype(np.float32) for v in vids[::5]])


def _random_keys():
    rng = np.random.default_rng(3)
    return _poses([_rot(rng.uniform(-170, 170, 3)) for _ in range(6)])


def _wrap_keys():
    """Yaw on both sides of +-180 degrees: the unwrap adds 360."""
    return _poses([_rot([10, 20, 175]), _rot([-5, 10, -178]),
                   _rot([170, -10, -170])], seed=1)


def _gimbal_keys():
    """Pitch at +-90 degrees: cy <= 1e-6, the other branch of the euler
    angles."""
    m = _rot([30, 90, 0])
    m2 = _rot([-40, -90, 0])
    assert np.sqrt(max(1 - m[2, 0] ** 2, 0)) <= 1e-6
    return _poses([m, _rot([0, 10, 20]), m2], seed=2)


@pytest.mark.parametrize("keys", ["fixture", "random", "wrap", "gimbal"])
@pytest.mark.parametrize("n_views", [1, 8, 30])
def test_gen_render_path_bitwise(keys, n_views):
    c2ws = {"fixture": _fixture_keys, "random": _random_keys,
            "wrap": _wrap_keys, "gimbal": _gimbal_keys}[keys]()
    want = jpaths.gen_render_path(c2ws, n_views)
    got = tpaths.gen_render_path(c2ws, n_views)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape == (len(c2ws) * max(n_views // 3, 1), 4, 4)
    np.testing.assert_array_equal(got, want)
    for m in (c2ws[0, :3, :3], c2ws[-1, :3, :3]):
        np.testing.assert_array_equal(tpaths._euler_xyz_from_matrix(m),
                                      jpaths._euler_xyz_from_matrix(m))


# ------------------------------------------------------- scenes and runs

def _nerf_preset(pkg):
    base = pkg.tiny_test()
    return base.replace(
        name=NERF_PRESET,
        querier=dataclasses.replace(base.querier,
                                    ranges=(-1.2,) * 3 + (1.2,) * 3),
        agg=dataclasses.replace(base.agg, use_nearest=0, drop_ratio=0.0),
        render=dataclasses.replace(base.render, near_plane=2.0,
                                   far_plane=6.0),
        sampling=dataclasses.replace(base.sampling, eval_chunk_rays=512),
        image_hw=(32, 32))


def _object_points(n, seed=0):
    """A textured ball of radius 0.6 around the origin, the Blender
    scene's object."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    xyz = (0.6 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    return dict(xyz=xyz, conf=rng.uniform(0.5, 1.0, (n, 1)),
                color=rng.uniform(0, 1, (n, 3)), dirs=rng.normal(size=(n, 3)),
                embedding=rng.standard_normal((n, 8)) * 0.1)


def _save_state(jc, pts_arrays, ck_dir):
    pts = jnpts.init_from_arrays(
        pts_arrays["xyz"], jc.points, embedding=pts_arrays["embedding"],
        conf=pts_arrays["conf"], color=pts_arrays["color"],
        dirs=pts_arrays["dirs"])
    tree = numpy_params(lambda k: jrenderer.init_params(k, jc))
    tree["aggregator"]["alpha"][-1]["b"] += np.float32(3.0)
    ts = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, tree),
                                   pts, jc)
    jck.save_checkpoint(ck_dir, ts, best_psnr=1.0)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A fake ScanNet scene and a Blender scene, each with one JAX-saved
    checkpoint per package's checkpoints dir (tiny and the NeRF preset)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_fixture_scene import make_blender_fixture
    mp = pytest.MonkeyPatch()
    for pkg in (JC, TC):
        mp.setitem(pkg.PRESETS, NERF_PRESET,
                   functools.partial(_nerf_preset, pkg))
    base = tmp_path_factory.mktemp("paths")
    mp.setenv("HNR_COMPILE_CACHE", str(base / "jax_cache"))
    root = str(base / "scans")
    write_fake_scannet(root, SCANNET_SCAN, n_frames=12, ext="png")
    make_blender_fixture(root, NERF_SCAN, n_train=4, n_test=3, H=32, W=32)
    for label in ("jax", "port"):
        _save_state(JC.tiny_test(), _wall_points(1500),
                    str(base / label / "tiny" / "ckpt"))
        _save_state(_nerf_preset(JC), _object_points(1500),
                    str(base / label / NERF_PRESET / "ckpt"))
    yield base, root
    mp.undo()


SCANNET_VID = ["--preset", "tiny", "--scan", SCANNET_SCAN, "--frames", "6",
               "--key-stride", "1", "--fps", "5"]
NERF_VID = ["--preset", NERF_PRESET, "--scan", NERF_SCAN, "--frames", "4",
            "--radius", "3.5", "--phi", "-20"]
SCANNET_VIS = ["--preset", "tiny", "--scan", SCANNET_SCAN, "--frames", "3"]
NERF_VIS = ["--preset", NERF_PRESET, "--scan", NERF_SCAN, "--frames", "2"]
RUNS = {"scannet_vid": (jvid, tvid, SCANNET_VID, "tiny_vid"),
        "nerf_vid": (jvid, tvid, NERF_VID, NERF_PRESET + "_vid"),
        "scannet_vis": (jvis, tvis, SCANNET_VIS, "tiny_vis"),
        "nerf_vis": (jvis, tvis, NERF_VIS, NERF_PRESET + "_vis")}


@pytest.fixture(scope="module")
def runs(scenes):
    """Each CLI of both packages on its scene: {run: {label: out dir}}."""
    base, root = scenes
    out = {}
    for run, (jmod, tmod, flags, sub) in RUNS.items():
        out[run] = {}
        for label in ("jax", "port"):
            ck = str(base / label)
            argv = flags + ["--data-root", root, "--checkpoints-dir", ck]
            if label == "jax":
                jmod.main(argv)
            else:
                tmod.main(argv + ["--device", "cpu"])
            out[run][label] = os.path.join(ck, sub)
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_frames_match(runs, run):
    jdir, tdir = (os.path.join(runs[run][k], "images")
                  for k in ("jax", "port"))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert len(names) == {"scannet_vid": 6, "nerf_vid": 4, "scannet_vis": 3,
                          "nerf_vis": 2}[run]
    for name in names:
        want = png.read(os.path.join(jdir, name)).astype(int)
        got = png.read(os.path.join(tdir, name)).astype(int)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name
    assert got.std() > 3, "the render is flat: no point was hit"


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_log_lines_match(runs, run):
    want, got = (_log_lines(runs[run][k]) for k in ("jax", "port"))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        if a.startswith("video written: "):
            assert os.path.basename(a) == os.path.basename(b) == "video.gif"
        elif ": PSNR " in a:
            ha, va = a.split(": PSNR ")
            hb, vb = b.split(": PSNR ")
            assert ha == hb and abs(float(va) - float(vb)) <= 0.0101
        else:
            assert a == b


@pytest.mark.parametrize("run", ["scannet_vid", "nerf_vid"])
def test_cli_videos_match(runs, run):
    import imageio.v2 as imageio
    jv, tv = (imageio.mimread(os.path.join(runs[run][k], "video.gif"))
              for k in ("jax", "port"))
    assert len(tv) == len(jv) == len(os.listdir(
        os.path.join(runs[run]["port"], "images")))
    pngs = sorted(os.listdir(os.path.join(runs[run]["port"], "images")))
    same = 0
    for a, b, name in zip(tv, jv, pngs):
        assert a.shape == b.shape
        frame = png.read(os.path.join(runs[run]["port"], "images", name))
        if np.array_equal(png.read(os.path.join(runs[run]["jax"], "images",
                                                name)), frame):
            np.testing.assert_array_equal(a, b)
            same += 1
    assert same > 0


# ------------------------------------------------------- parts

def test_create_dataset(scenes):
    _, root = scenes
    tc, jc = TC.tiny_test(), JC.tiny_test()
    for name, scan, cls in (("scannet", SCANNET_SCAN, ScannetScene),
                            ("scannet_ft", SCANNET_SCAN, ScannetScene),
                            ("nerf_synth360", NERF_SCAN, NerfSynthScene)):
        cfg = tc if cls is ScannetScene else _nerf_preset(TC)
        got = tcreate(name, root, scan, cfg, "test")
        want = jcreate(name, root, scan, jc if cls is ScannetScene
                       else _nerf_preset(JC), "test")
        assert isinstance(got, cls) and got.id_list == want.id_list
    with pytest.raises(KeyError):
        tcreate("llff", root, SCANNET_SCAN, tc)


@pytest.mark.parametrize("family", ["scannet", "nerf"])
def test_path_view_and_poses_match(scenes, family):
    """scene_path_poses (bit for bit) and PathView batches (equal arrays)
    against the JAX CLI's, at a chunk of pixels as JAX's
    render_full_frame asks for them; without pixelcoords the port's batch
    covers the frame."""
    import argparse
    _, root = scenes
    if family == "scannet":
        jds = jcreate("scannet", root, SCANNET_SCAN, JC.tiny_test(), "train")
        tds = tcreate("scannet", root, SCANNET_SCAN, TC.tiny_test(), "train")
    else:
        jds = jcreate("nerf_synth", root, NERF_SCAN, _nerf_preset(JC), "test")
        tds = tcreate("nerf_synth", root, NERF_SCAN, _nerf_preset(TC),
                      "test")
    args = argparse.Namespace(frames=6, phi=-20.0, radius=3.5, key_stride=1)
    want = jvid.scene_path_poses(jds, args)
    got = tvid.scene_path_poses(tds, args)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pix = np.stack(np.meshgrid(np.arange(7), np.arange(3)), -1).reshape(
        -1, 1, 2).astype(np.float32) * 3
    jb = jvid.PathView(jds, want).get_batch(2, pixelcoords=pix)
    tb = tvid.PathView(tds, got).get_batch(2, pixelcoords=pix)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]),
                                      err_msg=k)
    full = tvid.PathView(tds, got).get_batch(2)
    assert full["raydir"].shape == (tds.height * tds.width, 3)


def test_gen_video_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
              for _ in range(4)]
    import imageio.v2 as imageio
    vids = {}
    for label, cls in (("jax", JVis), ("port", Visualizer)):
        vis = cls(str(tmp_path), label)
        for i, f in enumerate(frames):
            png.write(os.path.join(vis.img_dir, f"step-{i:04d}-path.png"), f)
        path = vis.gen_video(fps=10)
        assert os.path.basename(path) == "video.gif"
        vids[label] = imageio.mimread(path)
        assert vis.gen_video(pattern_dir=str(tmp_path)) is None
    assert len(vids["port"]) == len(vids["jax"]) == 4
    for a, b in zip(vids["port"], vids["jax"]):
        np.testing.assert_array_equal(a, b)


def test_gen_video_without_imageio(tmp_path, monkeypatch):
    """Where imageio is not installed, gen_video raises
    ModuleNotFoundError, as JAX's does."""
    vis = Visualizer(str(tmp_path), "run")
    png.write(os.path.join(vis.img_dir, "step-0000-path.png"),
              np.zeros((4, 4, 3), np.uint8))
    for name in ("imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ModuleNotFoundError, match="imageio"):
        vis.gen_video()
    with pytest.raises(ModuleNotFoundError, match="imageio"):
        JVis(str(tmp_path), "jax").gen_video()


def test_render_vid_needs_a_checkpoint(scenes, tmp_path):
    _, root = scenes
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tvid.main(SCANNET_VID + ["--data-root", root, "--checkpoints-dir",
                                 str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tvis.main(SCANNET_VIS + ["--data-root", root, "--checkpoints-dir",
                                 str(tmp_path), "--device", "cpu"])
