"""The port's native batch sampler (data/native_sampler.py, built from
csrc/sampler.cpp into build/torch_native/) against the JAX package's
binding of native/sampler.cpp, on the CPU.

Both libraries compile the same source with the same flags (the JAX
binding through its own load(), which runs native/Makefile; here on a copy
of native/ in a temporary directory, so that no other test's build of
native/libsampler.so races this one), so their batches must be equal bit
for bit.  The checks of JAX tests/test_data.py
hold too: pixels inside the margin, the ground truth gathered exactly,
ray directions within rtol 1e-4 / atol 1e-5 of data/scannet._np_raydir.
"""

import os
import shutil

import numpy as np
import pytest

from hybridneuralrendering_tpu.data import native_sampler as JNS
from hybridneuralrendering_tpu_torch.data import native_sampler as TNS
from hybridneuralrendering_tpu_torch.data.scannet import _np_raydir
from hybridneuralrendering_tpu_torch.ops import build as tbuild

# (H, W, margin, patch_num, patch_size, dilation min, max)
SHAPES = {"test_data": (48, 64, 2, 2, 4, 1, 3),
          "train_config": (480, 640, 10, 7, 8, 1, 4),
          "wide_dilation": (120, 160, 0, 3, 5, 2, 6)}


@pytest.fixture(scope="module")
def jax_binding(tmp_path_factory):
    """The JAX binding, built by its own load() from a copy of native/."""
    native = tmp_path_factory.mktemp("native")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    for name in ("Makefile", "sampler.cpp"):
        shutil.copy(os.path.join(src, name), native / name)
    mp = pytest.MonkeyPatch()
    mp.setattr(JNS, "_LIB_PATH", str(native / "libsampler.so"))
    mp.setattr(JNS, "_lib", None)
    assert JNS.load() is not None, "the JAX binding did not build"
    yield JNS
    mp.undo()


def _inputs(shape, seed=0):
    H, W = shape[:2]
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    intr = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                    np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return img, intr, q.astype(np.float32)


def _args(shape, img, intr, rot, seed):
    _, _, margin, pn, ps, dmin, dmax = shape
    return (img, margin, pn, ps, dmin, dmax, intr, rot, seed)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_assemble_batch_bitwise_with_jax_binding(jax_binding, name, seed):
    shape = SHAPES[name]
    img, intr, rot = _inputs(shape, seed % 97)
    want = jax_binding.assemble_batch(*_args(shape, img, intr, rot, seed))
    assert want is not None
    got = TNS.assemble_batch(*_args(shape, img, intr, rot, seed))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_native_batch_semantics(name):
    """JAX tests/test_data.py's checks of a native batch."""
    shape = SHAPES[name]
    H, W, margin, pn, ps = shape[:5]
    img, intr, rot = _inputs(shape)
    xy, rgb, dirs = TNS.assemble_batch(*_args(shape, img, intr, rot, 7))
    side = pn * ps
    assert xy.shape == (side, side, 2) and rgb.shape == dirs.shape == (
        side * side, 3)
    assert xy[..., 0].min() >= margin and xy[..., 0].max() < W - margin
    assert xy[..., 1].min() >= margin and xy[..., 1].max() < H - margin
    flat = xy.reshape(-1, 2).astype(int)
    np.testing.assert_array_equal(rgb, img[flat[:, 1], flat[:, 0]])
    np.testing.assert_allclose(dirs, _np_raydir(xy.reshape(-1, 2), intr,
                                                rot), rtol=1e-4, atol=1e-5)
    again = TNS.assemble_batch(*_args(shape, img, intr, rot, 7))
    other = TNS.assemble_batch(*_args(shape, img, intr, rot, 8))
    assert all(np.array_equal(a, b) for a, b in zip(again, (xy, rgb, dirs)))
    assert not np.array_equal(other[0], xy)


@pytest.mark.parametrize("workers", [1, 3])
def test_pipeline_equals_assemble_batch_seed_for_seed(workers):
    """Each popped ticket's batch is assemble_batch's at the seed it was
    submitted with, whatever order the workers finish in."""
    shape = SHAPES["train_config"]
    img, intr, rot = _inputs(shape)
    seeds = [11, 12, 13, 14, 15, 16]
    with TNS.PrefetchPipeline(workers) as pipe:
        tickets = {pipe.submit(*_args(shape, img, intr, rot, s)): s
                   for s in seeds}
        popped = [pipe.pop() for _ in seeds]
    assert sorted(tickets) == list(range(len(seeds)))
    assert sorted(p[0] for p in popped) == sorted(tickets)
    for ticket, xy, rgb, dirs in popped:
        want = TNS.assemble_batch(*_args(shape, img, intr, rot,
                                         tickets[ticket]))
        np.testing.assert_array_equal(xy, want[0].reshape(-1, 2))
        np.testing.assert_array_equal(rgb, want[1])
        np.testing.assert_array_equal(dirs, want[2])


def test_pipeline_refuses_after_close_and_pop_without_submit():
    shape = SHAPES["test_data"]
    img, intr, rot = _inputs(shape)
    pipe = TNS.PrefetchPipeline(1)
    with pytest.raises(RuntimeError, match="pop without"):
        pipe.pop()
    pipe.close()
    pipe.close()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(*_args(shape, img, intr, rot, 1))


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild, "NATIVE_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tbuild, "_LOADED", {})


def test_build_without_a_compiler_raises(monkeypatch, tmp_path):
    """No host compiler: load raises, and assemble_batch never returns
    None (the JAX binding's fallback signal)."""
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(tbuild.shutil, "which", lambda name: None)
    shape = SHAPES["test_data"]
    img, intr, rot = _inputs(shape)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        TNS.assemble_batch(*_args(shape, img, intr, rot, 1))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        TNS.PrefetchPipeline(2)
    assert not (tmp_path / "native").exists() or not any(
        (tmp_path / "native").glob("*.so"))


def test_failed_build_raises_with_the_compiler_message(monkeypatch,
                                                       tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(tbuild.CSRC_DIR / "sampler.cpp", csrc / "sampler.cpp")
    with open(csrc / "sampler.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(tbuild, "CSRC_DIR", csrc)
    with pytest.raises(RuntimeError, match="failed for sampler") as e:
        TNS.load()
    assert "error" in str(e.value)
    assert not list((tmp_path / "native").glob("*.so"))


def test_source_is_native_sampler_cpp_below_its_header():
    """csrc/sampler.cpp is native/sampler.cpp from its first #include on;
    only the header comment, which says how each is built, differs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def body(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include"):]

    assert body(tbuild.CSRC_DIR / "sampler.cpp") == body(
        os.path.join(root, "native", "sampler.cpp"))
