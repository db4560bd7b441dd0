"""The port's presets equal the JAX package's, and the port loads no JAX."""

import dataclasses
import os
import subprocess
import sys

import pytest

import bench
from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu_torch import config as TC

SUBCONFIGS = ("querier", "points", "agg", "render", "sampling")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("preset", ["scannet_full", "tiny_test"])
def test_preset_fields_equal(preset):
    jc, tc = getattr(JC, preset)(), getattr(TC, preset)()
    for sub in SUBCONFIGS:
        assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub)), sub
    for name in ("name", "image_hw", "seed"):
        assert getattr(tc, name) == getattr(jc, name)


@pytest.mark.parametrize("sub", SUBCONFIGS)
def test_derived_properties_equal(sub):
    jc, tc = JC.scannet_full(), TC.scannet_full()
    jsub, tsub = getattr(jc, sub), getattr(tc, sub)
    props = [k for k, v in vars(type(jsub)).items()
             if isinstance(v, property)]
    for p in props:
        assert getattr(tsub, p) == getattr(jsub, p), p


def test_serve_config_is_the_bench_scene(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    jc, tc = bench.bench_config(), TC.serve_config()
    for sub in SUBCONFIGS:
        assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub)), sub
    assert tc.image_hw == jc.image_hw
    assert tc.points.num_points == bench.NUM_POINTS


def test_port_imports_no_jax():
    """Every module of the port loads without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hybridneuralrendering_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('hybridneuralrendering_tpu.')"
        " or m == 'hybridneuralrendering_tpu']\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('hybridneuralrendering_tpu_torch')]))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


TRAIN_SUBCONFIGS = ("blur", "loss", "optim", "probe")


@pytest.mark.parametrize("preset", ["scannet_full", "tiny_test"])
@pytest.mark.parametrize("sub", TRAIN_SUBCONFIGS)
def test_training_subconfigs_equal(preset, sub):
    jc, tc = getattr(JC, preset)(), getattr(TC, preset)()
    assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub))


def test_blur_num_kernels_equal():
    for preset in ("scannet_full", "tiny_test"):
        jc, tc = getattr(JC, preset)(), getattr(TC, preset)()
        assert tc.blur.num_kernels == jc.blur.num_kernels


def test_train_config_is_the_bench_training_shape(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    jc, tc = bench.bench_config(), TC.train_config()
    for sub in SUBCONFIGS + TRAIN_SUBCONFIGS:
        assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub)), sub
    assert tc.image_hw == jc.image_hw == (480, 640)
    assert tc.sampling.rays_per_batch == 3136
    assert tc.blur.add_blur_sim and tc.loss.use_frame_weight
    assert (tc.querier.z_depth_dim, tc.querier.SR, tc.querier.K) == \
        (400, 24, 8)


EVAL_PRESETS = ["scannet_full", "scannet_hybrid", "scannet_scene101",
                "scannet_learnable", "scannet_livingroom",
                "scannet_vangoroom", "fixture_room", "tiny",
                "nerf_synth_points", "nerf_synth_hybrid",
                "fixture_nerf_points", "fixture_nerf_hybrid"]
ALL_SUBCONFIGS = SUBCONFIGS + TRAIN_SUBCONFIGS + ("parallel",)


@pytest.mark.parametrize("name", EVAL_PRESETS)
def test_parallel_subconfig_equal(name):
    """The mesh layout (parallel/) of each preset equals JAX's, field by
    field, and its field names too."""
    jc, tc = JC.PRESETS[name](), TC.PRESETS[name]()
    assert _fields(tc.parallel) == _fields(jc.parallel)
    assert [f.name for f in dataclasses.fields(TC.ParallelConfig)] == \
        [f.name for f in dataclasses.fields(JC.ParallelConfig)]


@pytest.mark.parametrize("name", EVAL_PRESETS)
def test_named_presets_equal(name):
    """PRESETS[name] of the port equals the JAX package's, field by field,
    with and without a scan name where the preset takes one."""
    jp, tp = JC.PRESETS[name], TC.PRESETS[name]
    calls = [()] if name == "tiny" else [(), ("scene0000_00",)]
    for args in calls:
        jc, tc = jp(*args), tp(*args)
        for sub in ALL_SUBCONFIGS:
            assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub)), \
                (name, sub)
        for f in ("name", "image_hw", "seed"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)


def test_presets_carry_the_jax_names():
    assert set(JC.PRESETS) <= set(TC.PRESETS)


def test_nerf_train_config_equals_bench_config_nerf(monkeypatch):
    """nerf_train_config() is the JAX bench's NeRF workload with its
    environment knobs unset, and NERF_NUM_POINTS its scene size."""
    for k in ("BENCH_COMPUTE_DTYPE", "BENCH_PYRAMID_DTYPE",
              "BENCH_SHADING_DTYPE", "BENCH_FUSED_VJP", "BENCH_REMAT_CHAIN",
              "BENCH_CHAIN_CHUNKS", "BENCH_DEDUP"):
        monkeypatch.delenv(k, raising=False)
    jc, tc = bench.bench_config_nerf(), TC.nerf_train_config()
    for sub in ALL_SUBCONFIGS:
        assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub)), sub
    for f in ("name", "image_hw", "seed"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert TC.NERF_NUM_POINTS == bench.NUM_POINTS_NERF
    assert (tc.agg.remat_chain, tc.agg.chain_chunks, tc.querier.SR,
            tc.sampling.rays_per_batch) == (True, 16, 80, 3600)


@pytest.mark.parametrize("mode", ["preset", "off", "bank", "learnable"])
@pytest.mark.parametrize("frame_weight", [-1, 0, 1])
def test_blur_overrides_equal(mode, frame_weight):
    for name in ("scannet_full", "scannet_hybrid", "scannet_learnable",
                 "tiny"):
        jc = JC.apply_blur_overrides(JC.PRESETS[name](), mode, frame_weight)
        tc = TC.apply_blur_overrides(TC.PRESETS[name](), mode, frame_weight)
        for sub in ALL_SUBCONFIGS:
            assert _fields(getattr(tc, sub)) == _fields(getattr(jc, sub)), \
                (name, sub)


def test_blur_override_learnable_and_unknown_raise():
    """An unknown blur mode raises; 'learnable' is ported and no longer
    does (test_blur_overrides_equal)."""
    assert TC.apply_blur_overrides(TC.scannet_full(),
                                   "learnable").agg.learnable_blur_kernel
    with pytest.raises(KeyError):
        TC.apply_blur_overrides(TC.scannet_full(), "sometimes")


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names no jax and no module of the JAX package in any
    import, at the top or inside a function."""
    import ast
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "hybridneuralrendering_tpu_torch.cli" in names
    bad = [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "hybridneuralrendering_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (here), and alone in a directory without the port, the
    smoke exits non-zero and prints no result line."""
    import shutil

    import torch
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "chip_smoke.py")
    cwd = root
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
