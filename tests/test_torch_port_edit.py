"""Scene editing in the port against the JAX package: cli/edit (load_part,
merge_parts, main), the per-point rw2c through points, gather, aggregator
and render, Visualizer.save_neural_points, and what prune, grow and the
checkpoint do with rw2c.

Tolerances:
- gather of rw2c, load_part's arrays, merge_parts' table, mask, capacity
  and rw2c, the points dump: bit for bit (copies and the same numpy
  arithmetic);
- aggregator.apply with rotations: tests/test_torch_port_render.py's
  float32 limits (rtol 1e-4, atol 1e-5);
- the edit CLIs on a tiny two-part scene: log lines equal up to the
  timestamp and the video's directory, points/step-0.txt equal byte for
  byte, PNGs within 1 level, rays of the merged scene within the float32
  limits (tests/test_torch_port_eval_cli.py's for tiny_test);
- the roomsim fixture (fixture_room, bf16 chain): colours within 5e-3,
  ray masks equal (tests/test_torch_port_eval_cli.py's limits for it).
A planted fault, the port's render with rw2c dropped, must differ from
JAX's by more than those limits.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import edit as jedit
from hybridneuralrendering_tpu.cli import render_vid as jvid
from hybridneuralrendering_tpu.models import aggregator as jagg
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import state as jstate
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu.utils.visualizer import Visualizer as JVis
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.cli import edit as tedit
from hybridneuralrendering_tpu_torch.cli import render_vid as tvid
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.device import device_batch
from hybridneuralrendering_tpu_torch.io import png
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.train import checkpoint as tck
from hybridneuralrendering_tpu_torch.utils.visualizer import Visualizer
from test_torch_port_eval_cli import _log_lines
from test_torch_port_render import ALPHA_BIAS, F32, _agg_inputs
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    configs, make_params, make_scene, n, numpy_params, one_torch_thread, t)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(ROOT, ".fixture")
FIXTURE_CKPT = os.path.join(FIXTURE_ROOT, "ckpts/roomsim_full/ckpt")
FIXTURE_COLOUR_TOL = 5e-3
PART_POINTS = 1200
# the moved part: 30 degrees about z, then a shift inside tiny's ranges
ANGLE, SHIFT = np.deg2rad(30.0), (0.3, -0.2, 0.1)


def _rotations(shape, rng):
    """Random proper rotations [*shape, 3, 3] f32."""
    q, r = np.linalg.qr(rng.normal(size=tuple(shape) + (3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _transform():
    c, s = np.cos(ANGLE), np.sin(ANGLE)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = SHIFT
    return T


# ------------------------------------------------------- aggregator, gather

def test_aggregator_apply_rw2c_matches_jax():
    """Random rotations per neighbour, a third of the samples with
    neighbour 0 masked (its rotation still turns the view direction)."""
    jc, tc = configs()
    jp, tp = make_params(jc)
    a = _agg_inputs(tc)
    a["pnt_mask"][::3, :, 0] = False
    R, SR, K = a["pnt_mask"].shape
    rw = _rotations((R, SR, K), np.random.default_rng(11))
    vs = tc.querier.query_vsize
    ref = jax.jit(lambda p, kw: jagg.apply(p, jc.agg, vsize=vs, **kw))(
        jp["aggregator"], {**{k: jnp.asarray(v) for k, v in a.items()},
                           "sampled_rw2c": jnp.asarray(rw)})
    out = tagg.apply(tp["aggregator"], tc.agg, vsize=vs,
                     sampled_rw2c=t(rw), **{k: t(v) for k, v in a.items()})
    for k in ("features", "ray_valid", "weight", "conf_coefficient"):
        np.testing.assert_allclose(n(getattr(out, k)),
                                   np.asarray(getattr(ref, k)), **F32,
                                   err_msg=k)
    plain = tagg.apply(tp["aggregator"], tc.agg, vsize=vs,
                       **{k: t(v) for k, v in a.items()})
    assert np.abs(n(plain.features) - n(out.features)).max() > 1e-2
    # identity rotations change nothing
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), rw.shape).copy()
    same = tagg.apply(tp["aggregator"], tc.agg, vsize=vs,
                      sampled_rw2c=t(eye), **{k: t(v) for k, v in a.items()})
    np.testing.assert_allclose(n(same.features), n(plain.features),
                               rtol=1e-6, atol=1e-7)


def test_gather_rw2c_bitwise():
    """A slot reads its point's rotation; an empty slot (-1) point 0's, as
    JAX clamps the id."""
    jc, tc = configs()
    (jpts, _), (tpts, _) = make_scene(jc, tc, num_points=300)
    rng = np.random.default_rng(2)
    rw = _rotations((tpts.capacity,), rng)
    jpts = jpts._replace(rw2c=jnp.asarray(rw))
    tpts = dataclasses.replace(tpts, rw2c=t(rw))
    idx = rng.integers(-1, 300, (5, 6, 4)).astype(np.int32)
    idx[0, 0, 0] = -1
    js = jnpts.gather(jpts, jnp.asarray(idx))
    ts = tnpts.gather(tpts, t(idx))
    np.testing.assert_array_equal(n(ts.rw2c), np.asarray(js.rw2c))
    np.testing.assert_array_equal(n(ts.rw2c[0, 0, 0]), rw[0])
    assert tnpts.gather(dataclasses.replace(tpts, rw2c=None),
                        t(idx)).rw2c is None


def test_prune_grow_checkpoint_keep_rw2c(tmp_path):
    """prune and grow carry rw2c over unchanged, as JAX's; a checkpoint
    writes it as points/rw2c, as JAX's, and a load leaves it out; a JAX
    file with it loads in the port and the port's in JAX."""
    jc, tc = configs()
    (jpts, _), (tpts, _) = make_scene(jc, tc, num_points=300)
    rw = _rotations((tpts.capacity,), np.random.default_rng(4))
    jpts = jpts._replace(rw2c=jnp.asarray(rw))
    tpts = dataclasses.replace(tpts, rw2c=t(rw))
    pruned = tnpts.prune(tpts, 0.7)
    jpruned = jnpts.prune(jpts, 0.7)
    np.testing.assert_array_equal(n(pruned.mask), np.asarray(jpruned.mask))
    np.testing.assert_array_equal(n(pruned.rw2c), rw)
    np.testing.assert_array_equal(np.asarray(jpruned.rw2c), rw)
    m = 20
    rng = np.random.default_rng(5)
    new = [rng.normal(size=(m, w)).astype(np.float32) for w in (3, 8, 1, 3, 3)]
    grown = tnpts.grow(pruned, *map(t, new), t(np.ones(m, bool)))
    jgrown = jnpts.grow(jpruned, *map(jnp.asarray, new),
                        jnp.ones(m, bool))
    np.testing.assert_array_equal(n(grown.table), np.asarray(jgrown.table))
    np.testing.assert_array_equal(n(grown.rw2c), np.asarray(jgrown.rw2c))

    jp, tp = make_params(jc)
    jts = jstate.create_train_state(jp, jpts, jc)
    tts = tck.load_checkpoint(jck.save_checkpoint(str(tmp_path / "j"), jts),
                              tc, device="cpu")[0]
    assert tts.points.rw2c is None
    tts = dataclasses.replace(tts, points=tpts)
    with np.load(tck.save_checkpoint(str(tmp_path / "t"), tts)) as tf, \
            np.load(os.path.join(str(tmp_path / "j"), "0_state.npz")) as jf:
        assert sorted(tf.files) == sorted(jf.files)
        assert "points/rw2c" in tf.files
        np.testing.assert_array_equal(tf["points/rw2c"], jf["points/rw2c"])
    tmpl = jstate.create_train_state(
        jp, jnpts.init_from_arrays(np.zeros((1, 3), np.float32), jc.points),
        jc)
    back, _ = jck.load_checkpoint(os.path.join(str(tmp_path / "t"),
                                               "0_state.npz"), tmpl)
    assert back.points.rw2c is None
    np.testing.assert_array_equal(np.asarray(back.points.table),
                                  n(tpts.table))


@pytest.mark.parametrize("colour", [True, False])
def test_save_neural_points_bytes(tmp_path, colour):
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(257, 3)).astype(np.float32)
    col = rng.uniform(-0.1, 1.1, (257, 3)).astype(np.float32)
    jpath = JVis(str(tmp_path), "jax").save_neural_points(
        xyz, 3, col if colour else None)
    tpath = Visualizer(str(tmp_path), "port").save_neural_points(
        t(xyz), 3, col if colour else None)
    assert os.path.basename(tpath) == os.path.basename(jpath) == "step-3.txt"
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


# ------------------------------------------------------- parts and the CLI

def _save_part(jc, path, seed=0):
    """A JAX-saved state of tiny's synthetic points, its density head
    raised so that colours come from the points."""
    tc = TC.tiny_test()
    a = tsyn.scene_arrays(tc, PART_POINTS, seed)
    pts = jnpts.init_from_arrays(a["xyz"], jc.points,
                                 embedding=a["embedding"], conf=a["conf"],
                                 color=a["color"], dirs=a["dirs"])
    tree = numpy_params(lambda k: jrenderer.init_params(k, jc), seed)
    tree["aggregator"]["alpha"][-1]["b"] += np.float32(ALPHA_BIAS)
    ts = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, tree),
                                   pts, jc)
    jck.save_checkpoint(path, ts, best_psnr=0.0)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Two checkpoint roots holding the same JAX-saved part ("partA"), an
    index file of every second live point, one of all, the identity and a
    rotating transform."""
    base = tmp_path_factory.mktemp("edit")
    _save_part(JC.tiny_test(), str(base / "jax" / "partA" / "ckpt"))
    shutil.copytree(base / "jax" / "partA", base / "port" / "partA")
    files = {"half": base / "half.txt", "all": base / "all.txt",
             "id": base / "id.txt", "rot": base / "rot.txt"}
    np.savetxt(files["half"], np.arange(0, PART_POINTS, 2), fmt="%d")
    np.savetxt(files["all"], np.arange(PART_POINTS), fmt="%d")
    np.savetxt(files["id"], np.eye(4))
    np.savetxt(files["rot"], _transform())
    return base, {k: str(v) for k, v in files.items()}


@pytest.mark.parametrize("index,trf", [(None, None), ("half", "rot"),
                                       ("all", "rot"), ("half", None)])
def test_load_part_bitwise(parts, index, trf):
    base, files = parts
    ck = str(base / "jax" / "partA" / "ckpt")
    jc, tc = JC.tiny_test(), TC.tiny_test()
    jparams, ja = jedit.load_part(ck, jc, files.get(index),
                                  files.get(trf))
    tparams, ta = tedit.load_part(ck, tc, files.get(index), files.get(trf),
                                  device="cpu")
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert len(ta["xyz"]) == (PART_POINTS // 2 if index == "half"
                              else PART_POINTS)
    if trf:
        assert not np.allclose(ta["rw2c"][0], np.eye(3))
    jl = jax.tree_util.tree_leaves(jparams)
    tl = [x for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x, tparams,
                               is_leaf=torch.is_tensor))]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("which", ["fits", "grows"])
def test_merge_parts_bitwise(parts, which):
    """[whole, half moved] fits tiny's 2,048 slots; [whole, whole moved]
    takes 2,400 and rounds the capacity up to 3,072."""
    base, files = parts
    ck = str(base / "jax" / "partA" / "ckpt")
    jc, tc = JC.tiny_test(), TC.tiny_test()
    second = "half" if which == "fits" else "all"
    jparts = [jedit.load_part(ck, jc)[1],
              jedit.load_part(ck, jc, files[second], files["rot"])[1]]
    tparts = [tedit.load_part(ck, tc, device="cpu")[1],
              tedit.load_part(ck, tc, files[second], files["rot"],
                              device="cpu")[1]]
    jm = jedit.merge_parts(jparts, jc)
    tm = tedit.merge_parts(tparts, tc, device="cpu")
    assert tm.capacity == jm.capacity == (2048 if which == "fits" else 3072)
    assert tm.num_live == int(jm.num_live)
    for k in ("table", "mask", "rw2c"):
        np.testing.assert_array_equal(n(getattr(tm, k)),
                                      np.asarray(getattr(jm, k)), err_msg=k)


EDIT_FLAGS = ["--preset", "tiny", "--parts", "partA", "partA",
              "--out-name", "edited", "--render-frames", "3",
              "--image-hw", "24", "32", "--radius", "2.5", "--phi", "-20",
              "--fps", "5"]


@pytest.fixture(scope="module")
def edits(parts):
    """Both edit CLIs: part A whole, and every second point of it turned
    30 degrees about z and shifted.  Returns {label: (out dir, (params,
    points, grid))}."""
    base, files = parts
    out = {}
    for label, mod in (("jax", jedit), ("port", tedit)):
        ck = str(base / label)
        argv = EDIT_FLAGS + ["--checkpoints-dir", ck, "--index-files",
                             files["all"], files["half"], "--transforms",
                             files["id"], files["rot"]]
        res = mod.main(argv + (["--device", "cpu"] if label == "port"
                               else []))
        out[label] = (os.path.join(ck, "edited"), res)
    return out


def test_edit_cli_log_lines(edits):
    want, got = (_log_lines(edits[k][0]) for k in ("jax", "port"))
    assert len(got) == len(want) == 3 + 3 + 1
    for a, b in zip(got, want):
        if a.startswith("edited-scene video written: "):
            assert os.path.basename(a) == os.path.basename(b) == "video.gif"
        else:
            assert a == b
    assert want[1].endswith("(transformed by " + os.path.join(
        os.path.dirname(os.path.dirname(edits["jax"][0])), "rot.txt)"))


def test_edit_cli_points_dump(edits):
    jpath, tpath = (os.path.join(edits[k][0], "points", "step-0.txt")
                    for k in ("jax", "port"))
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    assert len(np.loadtxt(tpath, delimiter=";")) == PART_POINTS * 3 // 2


def test_edit_cli_frames(edits):
    jdir, tdir = (os.path.join(edits[k][0], "images")
                  for k in ("jax", "port"))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names == [
        f"step-{i:04d}-edited.png" for i in range(3)]
    for name in names:
        want = png.read(os.path.join(jdir, name)).astype(int)
        got = png.read(os.path.join(tdir, name)).astype(int)
        assert got.shape == want.shape == (24, 32, 3)
        assert np.abs(got - want).max() <= 1, name
        assert got.std() > 3, f"{name} is flat: no point was hit"


def _orbit_batch(pkg_edit, pkg_vid, cfg, points_xyz, live, pose_idx=1,
                 num=96, seed=9):
    """A batch of `num` pixels of orbit pose `pose_idx` (EDIT_FLAGS'
    orbit) from one package's PathView over its OrbitBase."""
    rng = np.random.default_rng(seed)
    pix = np.stack([rng.uniform(0, 32, num), rng.uniform(0, 24, num)],
                   -1).astype(np.float32)[:, None]
    poses = tedit.orbit_poses(points_xyz[live].mean(axis=0), 3, -20.0, 2.5)
    return pkg_vid.PathView(pkg_edit.OrbitBase(cfg, (24, 32)),
                            poses).get_batch(pose_idx, pixelcoords=pix)


def test_edit_cli_merged_rays(edits):
    """Rays of orbit pose 1 through each CLI's merged scene: within the
    float32 limits of JAX's; with the port's rw2c dropped (a planted
    fault), not."""
    jparams, jpts, jgrid = edits["jax"][1]
    tparams, tpts, tgrid = edits["port"][1]
    xyz, live = n(tpts.xyz), n(tpts.mask)
    b = _orbit_batch(tedit, tvid, TC.tiny_test(), xyz, live)
    jb = _orbit_batch(jedit, jvid, JC.tiny_test(), xyz, live)
    assert jb.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    jout = jstep.eval_step(jparams, jpts, jgrid,
                           jstep.device_batch(jb), JC.tiny_test())
    tout = serve.eval_step(tparams, tpts, tgrid, device_batch(b, "cpu"),
                           TC.tiny_test())
    np.testing.assert_array_equal(n(tout["ray_mask"]),
                                  np.asarray(jout["ray_mask"]))
    assert n(tout["ray_mask"]).mean() > 0.3
    for k in ("coarse_raycolor", "coarse_point_opacity",
              "coarse_is_background"):
        np.testing.assert_allclose(n(tout[k]), np.asarray(jout[k]), **F32,
                                   err_msg=k)
    fault = serve.eval_step(tparams, dataclasses.replace(tpts, rw2c=None),
                            tgrid, device_batch(b, "cpu"), TC.tiny_test())
    err = np.abs(n(fault["coarse_raycolor"])
                 - np.asarray(jout["coarse_raycolor"])).max()
    assert err > 10 * (F32["atol"] + F32["rtol"])


def test_edit_cli_needs_cuda_unless_told(parts):
    base, _ = parts
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tedit.main(["--preset", "tiny", "--parts", "partA",
                    "--checkpoints-dir", str(base / "port"),
                    "--out-name", "refused"])


def test_edit_cli_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tedit.main(["--preset", "tiny", "--parts", "nothing",
                    "--checkpoints-dir", str(tmp_path), "--device", "cpu"])


# ------------------------------------------------------- roomsim fixture

def test_fixture_part_matches_jax(tmp_path):
    """The trained roomsim fixture (fixture_room) as a part: every second
    live point through an index file, turned 30 degrees about z and
    shifted; 256 rays of test frame 0's camera through the merged points
    (no source views, as in the edit render) by JAX eval_step and by the
    port on the CPU."""
    ckpt = os.path.join(FIXTURE_CKPT, "2000_state.npz")
    if not os.path.exists(ckpt):
        pytest.skip("the fixture checkpoint is not in this checkout")
    jc, tc = JC.fixture_room(), TC.fixture_room()
    live = np.nonzero(np.load(ckpt)["points/mask"])[0]
    np.savetxt(tmp_path / "half.txt", live[::2], fmt="%d")
    np.savetxt(tmp_path / "rot.txt", _transform())
    args = (str(tmp_path / "half.txt"), str(tmp_path / "rot.txt"))
    jparams, ja = jedit.load_part(FIXTURE_CKPT, jc, *args)
    tparams, ta = tedit.load_part(FIXTURE_CKPT, tc, *args, device="cpu")
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    jpts = jedit.merge_parts([ja], jc)
    tpts = tedit.merge_parts([ta], tc, device="cpu")
    np.testing.assert_array_equal(n(tpts.table), np.asarray(jpts.table))
    jgeom = JVG.compute_grid_geometry(np.asarray(jpts.xyz),
                                      np.asarray(jpts.mask), jc.querier)
    jgrid = JVG.build_grid_jit(jpts.xyz, jpts.mask, jgeom, jc.querier)
    tgrid = TVG.grid_of(tpts.xyz, tpts.mask, tc.querier)

    pose = np.loadtxt(os.path.join(FIXTURE_ROOT, "roomsim/exported/pose/"
                                   "0.txt")).astype(np.float32)
    H, W = tc.image_hw
    pick = np.linspace(0, H * W - 1, 256).astype(np.int64)
    pix = np.stack([pick % W, pick // W], -1).astype(np.float32)[:, None]
    b = tvid.PathView(tedit.OrbitBase(tc), [pose]).get_batch(
        0, pixelcoords=pix)
    jout = jstep.eval_step(jparams, jpts, jgrid, jstep.device_batch(b), jc)
    tout = serve.render_rays(tparams, tpts, tgrid, device_batch(b, "cpu"),
                             tc)
    np.testing.assert_array_equal(n(tout["ray_mask"]),
                                  np.asarray(jout["ray_mask"]))
    assert n(tout["ray_mask"]).mean() > 0.3
    err = np.abs(n(tout["coarse_raycolor"])
                 - np.asarray(jout["coarse_raycolor"]))
    print(f"edited fixture: port vs JAX max abs {err.max():.3e} (limit "
          f"{FIXTURE_COLOUR_TOL})")
    assert err.max() <= FIXTURE_COLOUR_TOL
