"""Both trainer CLIs and both evaluation CLIs on a small NeRF-synthetic
(Blender-layout) scene on the CPU: the port's cli.train and cli.test
against the JAX package's, under a small NeRF preset registered in both
packages' PRESETS (its name starts with "nerf", which makes both CLIs read
the Blender layout).

The preset is tiny_test shaped as fixture_nerf_points: no image fusion,
no drop, no blur, no frame weight, 8 x 8 random rays, a white
background, near 2 / far 6, and the chain in 4 rematerialised chunks.
The scene is data/synthetic.write_blender_scene's object at 32 x 32, the
bootstrap its fused.ply (--load-points 1).  The port gets JAX's initial
parameters, embeddings and step noise as tests/test_torch_port_train_cli.py
carries them across, so the runs differ only by float32 summation order;
the tolerances are that file's: event lines and checkpoint steps equal,
loss means rtol 1e-3, eval PSNR 2e-3 dB, the checkpoints leaf for leaf;
scores.txt to 1e-4 relative (tests/test_torch_port_eval_cli.py).

Both CLIs fail alike, with AttributeError, on --load-points 2 (a Blender
scene has no sensor depth) and on --native-prefetch with a dilated NeRF
preset (the native path reads ScanNet poses).
"""

import dataclasses
import os

import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import test as jtest_cli
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.cli import test as ttest_cli
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from test_torch_port_eval_cli import _scores
from test_torch_port_train_cli import (SEED, _compare_checkpoints, _events,
                                       _log, _run)
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    one_torch_thread)

PRESET, HYBRID = "nerf_itest", "nerf_itest_hybrid"
SCAN = "nerfobj"
STEPS = 6
ARGS = ["--preset", PRESET, "--max-steps", str(STEPS), "--print-freq", "2",
        "--test-freq", "6", "--test-num", "1", "--save-freq", "3",
        "--load-points", "1", "--vox-res", "64", "--seed", str(SEED)]


def _preset(pkg):
    base = pkg.tiny_test()
    return base.replace(
        name=PRESET,
        querier=dataclasses.replace(base.querier,
                                    ranges=(-1.2,) * 3 + (1.2,) * 3),
        agg=dataclasses.replace(base.agg, use_nearest=0, drop_ratio=0.0,
                                remat_chain=True, chain_chunks=4),
        render=dataclasses.replace(base.render, near_plane=2.0,
                                   far_plane=6.0),
        sampling=dataclasses.replace(base.sampling, random_sample="random",
                                     random_sample_size=8,
                                     eval_chunk_rays=256),
        blur=dataclasses.replace(base.blur, add_blur_sim=False),
        loss=dataclasses.replace(base.loss, use_frame_weight=False),
        image_hw=(32, 32))


def _hybrid(pkg):
    base = _preset(pkg)
    return base.replace(
        name=HYBRID,
        agg=dataclasses.replace(base.agg, use_nearest=2, drop_ratio=0.5),
        sampling=dataclasses.replace(base.sampling, random_sample="dilated"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for pkg in (JC, TC):
        for name, fn in ((PRESET, _preset), (HYBRID, _hybrid)):
            # a preset without parameters: the CLIs pass a scan name to one
            # that takes one
            mp.setitem(pkg.PRESETS, name,
                       (lambda p, f: lambda: f(p))(pkg, fn))
    base = tmp_path_factory.mktemp("nerfcli")
    mp.setenv("HNR_COMPILE_CACHE", str(base / "jax_cache"))
    tsyn.write_blender_scene(str(base / "scans"), SCAN, n_train=8, n_test=3,
                             hw=(32, 32), num_points=1500)
    yield base, str(base / "scans")
    mp.undo()


@pytest.fixture(scope="module")
def runs(scene):
    base, root = scene
    out = {}
    for label in ("jax", "port"):
        ck = str(base / label)
        _run(label, ARGS + ["--data-root", root, "--scan", SCAN,
                            "--checkpoints-dir", ck], preset=_preset)
        argv = ["--preset", PRESET, "--data-root", root, "--scan", SCAN,
                "--checkpoints-dir", ck]
        if label == "jax":
            jtest_cli.main(argv)
        else:
            ttest_cli.main(argv + ["--device", "cpu"])
        out[label] = dict(dir=os.path.join(ck, PRESET),
                          test_dir=os.path.join(ck, PRESET + "_test"))
    return out


def test_nerf_runs_log_the_same_events(runs):
    want, got = _log(runs["jax"]["dir"]), _log(runs["port"]["dir"])
    assert _events(got) == _events(want)
    assert "bootstrapping points (mode 1)..." in got
    assert got[-1].startswith("done: 6 steps")


def test_nerf_print_and_eval_lines_match(runs):
    want, got = _log(runs["jax"]["dir"]), _log(runs["port"]["dir"])
    pick = lambda lines: [x for x in lines   # noqa: E731
                          if x.startswith(("step ", "eval step"))]
    pairs = list(zip(pick(want), pick(got)))
    assert len(pairs) == STEPS // 2 + 1 == len(pick(got))
    for a, b in pairs:
        assert a.split()[:3] == b.split()[:3]
        if a.startswith("eval"):
            assert float(b.split()[4]) == pytest.approx(float(a.split()[4]),
                                                        abs=2e-3)


@pytest.mark.parametrize("step", [3, 6])
def test_nerf_checkpoints_leaf_for_leaf(runs, step):
    names = [sorted(os.listdir(os.path.join(runs[k]["dir"], "ckpt")))
             for k in ("jax", "port")]
    assert names[0] == names[1] == ["3_state.npz", "6_state.npz",
                                    "run_config.json"]
    _compare_checkpoints(
        os.path.join(runs["port"]["dir"], "ckpt", f"{step}_state.npz"),
        os.path.join(runs["jax"]["dir"], "ckpt", f"{step}_state.npz"), step)


def test_nerf_scores_txt_agree(runs):
    want, got = _scores(runs["jax"]["test_dir"]), _scores(
        runs["port"]["test_dir"])
    assert set(want) == set(got) >= {"psnr", "ssim", "rmse"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    pngs = [sorted(os.listdir(os.path.join(runs[k]["test_dir"], "images")))
            for k in ("jax", "port")]
    assert pngs[0] == pngs[1] and len(pngs[1]) == 2 * 3


@pytest.mark.parametrize("flags", [["--load-points", "2"],
                                   ["--preset", HYBRID, "--native-prefetch",
                                    "2", "--load-points", "1"]])
def test_nerf_refusals_fail_alike(scene, flags, tmp_path):
    base, root = scene
    argv = ["--preset", PRESET, "--data-root", root, "--scan", SCAN,
            "--max-steps", "2", "--vox-res", "64", "--seed", str(SEED)]
    errs = []
    for label in ("jax", "port"):
        with pytest.raises(Exception) as e:
            _run(label, argv + flags + ["--checkpoints-dir",
                                        str(tmp_path / label)],
                 preset=_hybrid if HYBRID in flags else _preset)
        errs.append(e)
    assert errs[0].type is errs[1].type is AttributeError
    attr = [str(e.value).split("'")[-2] for e in errs]
    assert attr[0] == attr[1], attr
