"""The port's evaluation CLI (hybridneuralrendering_tpu_torch/cli/test.py)
against the JAX package's, and the port's render of the trained fixture
against JAX eval_step.

Tolerances:
  - tiny fake scene, float32 chains, one JAX-saved checkpoint: the two
    CLIs' renders differ only by float32 summation order, so the frames'
    8-bit PNGs differ by at most 1 level, the ground-truth PNGs are equal,
    and scores.txt agrees to 1e-4 relative (PSNR, SSIM, RMSE);
  - the trained roomsim fixture (fixture_room, bf16 pyramid and chain):
    the port's bf16 chain rounds as the TPU kernel does and JAX's shipped
    chain is bf16 end to end, so colours agree within 5e-3 (the limit of
    chip_smoke.py's card-vs-CPU check), with ray masks equal;
  - the slow full-frame test, both CLIs on the trained fixture: scores
    within 0.02 dB PSNR, 1e-3 SSIM and 2e-4 RMSE, PNG levels within 2
    (5e-3 of a colour is 1.3 levels).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import test as jcli
from hybridneuralrendering_tpu.data import sampling as jsampling
from hybridneuralrendering_tpu.data import scannet as jscannet
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import state as jstate
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.cli import test as tcli
from hybridneuralrendering_tpu_torch.data import scannet as tscannet
from hybridneuralrendering_tpu_torch.io import png
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.train import checkpoint as tck
from hybridneuralrendering_tpu_torch.utils import metrics as TM
from torch_port_common import numpy_params, write_fake_scannet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(ROOT, ".fixture")
FIXTURE_CKPT = os.path.join(FIXTURE_ROOT, "ckpts/roomsim_full")
SCORES_RTOL = 1e-4
FIXTURE_COLOUR_TOL = 5e-3
NUM_FRAMES = 3
CHUNK = 1024


def _wall_points(n, seed=0):
    """A textured wall at z = 1.5 in front of the fake scene's cameras."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.0, 1.6, n), rng.uniform(-0.8, 0.8, n),
                    1.5 + rng.normal(0, 0.01, n)], -1).astype(np.float32)
    return dict(xyz=xyz, conf=rng.uniform(0.5, 1.0, (n, 1)),
                color=rng.uniform(0, 1, (n, 3)), dirs=rng.normal(size=(n, 3)),
                embedding=rng.standard_normal((n, 8)) * 0.1)


@pytest.fixture(scope="module")
def clis(tmp_path_factory, monkeypatch_module):
    """The JAX and the port CLI on one fake scene and one JAX-saved
    checkpoint, each in its own checkpoints dir."""
    base = tmp_path_factory.mktemp("evalcli")
    monkeypatch_module.setenv("HNR_COMPILE_CACHE", str(base / "jax_cache"))
    root, scan = write_fake_scannet(base / "scans", n_frames=12, ext="jpg")
    jc = JC.tiny_test()
    a = _wall_points(1500)
    pts = jnpts.init_from_arrays(a["xyz"], jc.points,
                                 embedding=a["embedding"], conf=a["conf"],
                                 color=a["color"], dirs=a["dirs"])
    tree = numpy_params(lambda k: jrenderer.init_params(k, jc))
    tree["aggregator"]["alpha"][-1]["b"] += np.float32(3.0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ts = jstate.create_train_state(params, pts, jc)._replace(
        step=jnp.asarray(40, jnp.int32))
    outs = {}
    for label in ("jax", "port"):
        ck = base / label
        jck.save_checkpoint(str(ck / "tiny" / "ckpt"), ts, best_psnr=12.5)
        argv = ["--preset", "tiny", "--data-root", root, "--scan", scan,
                "--checkpoints-dir", str(ck), "--num-frames",
                str(NUM_FRAMES), "--eval-chunk", str(CHUNK)]
        if label == "jax":
            jcli.main(argv)
            ret = None
        else:
            ret = tcli.main(argv + ["--device", "cpu"])
        outs[label] = (str(ck / "tiny_test"), ret)
    return outs, (root, scan)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _scores(path):
    out = {}
    with open(os.path.join(path, "scores.txt")) as f:
        for line in f:
            k, v = line.split(": ")
            out[k] = float(v)
    return out


def test_scores_txt_equal(clis):
    outs, _ = clis
    jdir, _ = outs["jax"]
    tdir, ret = outs["port"]
    want, got = _scores(jdir), _scores(tdir)
    assert sorted(got) == sorted(want) == ["psnr", "rmse", "ssim"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=SCORES_RTOL), k
        # scores.txt holds the returned dict's values as Python prints them
        assert got[k] == ret[k]


@pytest.mark.parametrize("kind", ["coarse_raycolor", "gt_image"])
def test_frames_equal(clis, kind):
    outs, _ = clis
    jdir, tdir = outs["jax"][0], outs["port"][0]
    for fi in range(NUM_FRAMES):
        name = f"images/step-{fi:04d}-{kind}.png"
        want = png.read(os.path.join(jdir, name)).astype(int)
        got = png.read(os.path.join(tdir, name)).astype(int)
        assert got.shape == want.shape == (48, 64, 3)
        diff = np.abs(got - want).max()
        assert diff <= (1 if kind == "coarse_raycolor" else 0), (name, diff)
        if kind == "coarse_raycolor":
            assert got.std() > 5, "the render is flat: no point was hit"


def _log_lines(path):
    with open(os.path.join(path, "log.txt")) as f:
        return [line.split("] ", 1)[1].rstrip("\n") for line in f]


def test_log_lines_match(clis):
    outs, _ = clis
    want, got = _log_lines(outs["jax"][0]), _log_lines(outs["port"][0])
    assert len(got) == len(want)
    frame = re.compile(r"frame (\d+): PSNR ([\d.]+)  render [\d.]+s "
                       r"\(\d+ rays/s\)")
    jf = [frame.fullmatch(x) for x in want if x.startswith("frame")]
    tf = [frame.fullmatch(x) for x in got if x.startswith("frame")]
    assert len(tf) == len(jf) == NUM_FRAMES and all(tf) and all(jf)
    for a, b in zip(tf, jf):
        assert a.group(1) == b.group(1)
        assert float(a.group(2)) == pytest.approx(float(b.group(2)), abs=2e-3)
    assert got[0] == want[0]                      # effective dtypes line
    assert got[1].replace(os.path.dirname(outs["port"][0]), "") == \
        want[1].replace(os.path.dirname(outs["jax"][0]), "")  # loaded ...
    assert [x.split(":")[0] for x in got[-3:]] == ["psnr", "ssim", "rmse"]


def test_render_full_frame_equals_render_rays(clis):
    """render_full_frame is render_rays over every pixel of the frame, as
    one request, with a ragged last chunk (72 of the 3,072 rays in chunks
    of 1,000 here)."""
    _, (root, scan) = clis
    tc = TC.tiny_test().replace(sampling=TC.SamplingConfig(
        eval_chunk_rays=1000))
    ds = tscannet.ScannetScene(root, scan, tc, "test")
    st, _ = tck.load_checkpoint(
        tck.latest_checkpoint(os.path.join(clis[0]["port"][0], "..",
                                           "tiny", "ckpt")), tc, device="cpu")
    geom = TVG.compute_grid_geometry(st.points.xyz.numpy(),
                                     st.points.mask.numpy(), tc.querier,
                                     device="cpu")
    grid = TVG.build_grid(st.points.xyz, st.points.mask, geom, tc.querier)
    img = serve.render_full_frame(st.params, st.points, grid,
                                  ds.get_batch(1), tc, device="cpu")
    b = tscannet.device_batch(ds.get_batch(1), "cpu")
    ref = serve.render_rays(st.params, st.points, grid, b, tc)
    assert torch.equal(img, ref["coarse_raycolor"].reshape(48, 64, 3))
    with pytest.raises(NotImplementedError, match="plane"):
        serve.render_full_frame(
            st.params, st.points, grid, ds.get_batch(1),
            tc.replace(render=TC.RenderConfig(bgmodel="img_plane")),
            device="cpu")


def test_entry_points_default_to_the_card(clis):
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    _, (root, scan) = clis
    tc = TC.tiny_test()
    ds = tscannet.ScannetScene(root, scan, tc, "test")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--preset", "tiny", "--data-root", root, "--scan", scan])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.render_full_frame(None, None, None, ds.get_batch(0), tc)


@pytest.mark.parametrize("flags,match", [
    (["--blur-mode", "learnable"], "item 8"),
    (["--preset", "nerf_synth_points"], "items 8 and 11")])
def test_cli_refuses_unported(clis, flags, match):
    _, (root, scan) = clis
    argv = ["--preset", "tiny", "--data-root", root, "--scan", scan,
            "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(argv + flags)


def test_run_config_snapshot_rules():
    """The snapshot's blur mode, dtypes and capacity apply; explicit flags
    win (JAX cli/test.py's rules)."""
    ap = tcli.build_argparser()
    snap = {"blur_mode": "off", "pyramid_dtype": "float32",
            "shading_dtype": "float32", "num_points": 4096}
    cfg, mode = tcli.apply_snapshot(
        TC.scannet_full(), ap.parse_args(["--data-root", "x"]), snap)
    assert mode == "off" and not cfg.blur.add_blur_sim
    assert cfg.agg.pyramid_dtype == cfg.agg.shading_dtype == "float32"
    assert cfg.points.num_points == 4096
    cfg, mode = tcli.apply_snapshot(
        TC.scannet_full(), ap.parse_args(
            ["--data-root", "x", "--blur-mode", "bank", "--shading-dtype",
             "bfloat16", "--eval-chunk", "512"]), snap)
    assert mode == "bank" and cfg.blur.add_blur_sim
    assert (cfg.agg.pyramid_dtype, cfg.agg.shading_dtype) == (
        "float32", "bfloat16")
    assert cfg.sampling.eval_rays == 512


# ------------------------------------------------------- the trained fixture

@pytest.fixture(scope="module")
def fixture_renders():
    """Test frame 0 of roomsim, 1,920 rays on a strided pixel grid, rendered
    from the trained fixture checkpoint by JAX eval_step and by the port,
    both on the CPU at fixture_room (bf16 pyramid and chain)."""
    ckpt = os.path.join(FIXTURE_CKPT, "ckpt/2000_state.npz")
    if not os.path.exists(ckpt):
        pytest.skip("the fixture checkpoint is not in this checkout")
    jc, tc = JC.fixture_room(), TC.fixture_room()
    pix = jsampling.full_image_grid(*jc.image_hw)[::5, ::8].reshape(-1, 1, 2)

    st, _ = tck.load_checkpoint(ckpt, tc, device="cpu")
    geom = TVG.compute_grid_geometry(st.points.xyz.numpy(),
                                     st.points.mask.numpy(), tc.querier,
                                     device="cpu")
    grid = TVG.build_grid(st.points.xyz, st.points.mask, geom, tc.querier)
    tds = tscannet.ScannetScene(FIXTURE_ROOT, "roomsim", tc, "test")
    tb = tscannet.device_batch(tds.get_batch(0, pixelcoords=pix), "cpu")
    tout = serve.render_rays(st.params, st.points, grid, tb, tc)

    tmpl = jstate.create_train_state(
        jrenderer.init_params(jax.random.PRNGKey(0), jc),
        jnpts.init_from_arrays(np.zeros((1, 3), np.float32), jc.points), jc)
    jts, _ = jck.load_checkpoint(ckpt, tmpl)
    jgeom = JVG.compute_grid_geometry(np.asarray(jts.points.xyz),
                                      np.asarray(jts.points.mask),
                                      jc.querier)
    jgrid = JVG.build_grid_jit(jts.points.xyz, jts.points.mask, jgeom,
                               jc.querier)
    jds = jscannet.ScannetScene(FIXTURE_ROOT, "roomsim", jc, "test")
    jb = jstep.device_batch(jds.get_batch(0, pixelcoords=pix))
    jout = jstep.eval_step(jts.params, jts.points, jgrid, jb, jc)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()}, tb["gt_image"].numpy())


def test_trained_fixture_render_matches_jax(fixture_renders):
    jout, tout, gt = fixture_renders
    assert tout["coarse_raycolor"].shape == (1920, 3)
    np.testing.assert_array_equal(tout["ray_mask"], jout["ray_mask"])
    assert tout["ray_mask"].mean() > 0.9
    err = np.abs(tout["coarse_raycolor"] - jout["coarse_raycolor"])
    print(f"port vs JAX eval_step on the trained fixture: max abs "
          f"{err.max():.3e}, mean abs {err.mean():.3e} (limit "
          f"{FIXTURE_COLOUR_TOL})")
    assert err.max() <= FIXTURE_COLOUR_TOL
    np.testing.assert_allclose(tout["coarse_is_background"],
                               jout["coarse_is_background"],
                               atol=FIXTURE_COLOUR_TOL)


def test_trained_fixture_psnr_matches_jax(fixture_renders):
    jout, tout, gt = fixture_renders
    tp = TM.psnr(torch.as_tensor(tout["coarse_raycolor"]), gt)
    jp = TM.psnr(jout["coarse_raycolor"], gt)
    print(f"PSNR on the rays: port {tp:.4f}, JAX {jp:.4f}")
    assert tp > 30.0
    assert tp == pytest.approx(jp, abs=0.05)


@pytest.mark.slow
def test_trained_fixture_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the CPU over roomsim test frame 0, whole 240x320
    (minutes each), from the trained fixture checkpoint.  The recorded
    .fixture/ckpts/roomsim_full_test/scores.txt came from the JAX CLI on
    a TPU, whose default float32 matmul precision is lower: JAX on the CPU
    reads 0.36 dB more on this frame, and the port is held to JAX on the
    CPU."""
    src = os.path.join(FIXTURE_CKPT, "ckpt/2000_state.npz")
    if not os.path.exists(src):
        pytest.skip("the fixture checkpoint is not in this checkout")
    monkeypatch.setenv("HNR_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    dirs = {}
    for label in ("jax", "port"):
        ck = tmp_path / label
        (ck / "roomsim_full" / "ckpt").mkdir(parents=True)
        os.symlink(src, ck / "roomsim_full" / "ckpt" / "2000_state.npz")
        argv = ["--preset", "fixture_room", "--data-root", FIXTURE_ROOT,
                "--scan", "roomsim", "--checkpoints-dir", str(ck),
                "--num-frames", "1"]
        if label == "jax":
            jcli.main(argv)
        else:
            tcli.main(argv + ["--device", "cpu"])
        dirs[label] = str(ck / "roomsim_full_test")
    want, got = _scores(dirs["jax"]), _scores(dirs["port"])
    print(f"port scores {got}, JAX {want}")
    assert got["psnr"] == pytest.approx(want["psnr"], abs=0.02)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-3)
    assert got["rmse"] == pytest.approx(want["rmse"], abs=2e-4)
    name = "images/step-0000-coarse_raycolor.png"
    diff = np.abs(png.read(os.path.join(dirs["port"], name)).astype(int)
                  - png.read(os.path.join(dirs["jax"], name)).astype(int))
    print(f"frame 0: PNG levels differ by at most {diff.max()}, "
          f"{(diff > 0).mean():.4f} of the values differ")
    assert diff.max() <= 2
