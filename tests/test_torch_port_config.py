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


TRAIN_SUBCONFIGS = ("blur", "loss", "optim")


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
