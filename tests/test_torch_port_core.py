"""Parity of the port's core math and MLP blocks with the JAX package.

Same numpy inputs to both; float32 on the CPU.  Tolerances: elementwise
formulas written in the same order agree to float32 rounding (rtol 1e-6);
where the two frameworks sum in another order (cumsum, matmul, conv,
resize) the bound is rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.core import cameras as jcam
from hybridneuralrendering_tpu.core import encoding as jenc
from hybridneuralrendering_tpu.core import march as jmarch
from hybridneuralrendering_tpu.core import rays as jrays
from hybridneuralrendering_tpu.models import feature_pyramid as jfp
from hybridneuralrendering_tpu.models import mlp as jmlp
from hybridneuralrendering_tpu_torch.core import cameras as tcam
from hybridneuralrendering_tpu_torch.core import encoding as tenc
from hybridneuralrendering_tpu_torch.core import march as tmarch
from hybridneuralrendering_tpu_torch.core import rays as trays
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import feature_pyramid as tfp
from hybridneuralrendering_tpu_torch.models import mlp as tmlp
from torch_port_common import REORDERED, numpy_params

EXACT = dict(rtol=1e-6, atol=1e-7)


def rng(seed=0):
    return np.random.default_rng(seed)


def f32(a):
    return np.asarray(a, np.float32)


def tt(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("freqs,ori", [(3, False), (4, True), (1, False)])
def test_positional_encoding(freqs, ori):
    x = f32(rng().normal(size=(5, 7, 3)))
    close(tenc.positional_encoding(tt(x), freqs, ori),
          jenc.positional_encoding(jnp.asarray(x), freqs, ori), EXACT)


def test_linspace_matches_jnp():
    for n in (2, 33, 401):
        np.testing.assert_array_equal(
            trays.linspace01(n).numpy(), np.asarray(jnp.linspace(0., 1., n)))


@pytest.mark.parametrize("name", ["near_far_linear",
                                  "near_far_disparity_linear"])
@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_ray_generators(name, jitter):
    r = rng(1)
    campos = f32([0.1, -0.2, -2.0])
    d = f32(r.normal(size=(6, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    S = 40
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(key, (6, S)))
    ref = jrays.RAY_GENERATORS[name](jnp.asarray(campos), jnp.asarray(d), S,
                                     0.1, 4.0, jitter, key)
    out = trays.RAY_GENERATORS[name](tt(campos), tt(d), S, 0.1, 4.0, jitter,
                                     tt(noise))
    for o, e in zip(out, ref):
        close(o, e, REORDERED)


def test_cameras():
    r = rng(2)
    x = f32(r.uniform(-1, 1, (4, 5, 3)))
    q, _ = np.linalg.qr(r.normal(size=(3, 3)))
    rot = f32(q)
    campos = f32([0.2, 0.1, -3.0])
    close(tcam.w2pers(tt(x), tt(rot), tt(campos)),
          jcam.w2pers(jnp.asarray(x), jnp.asarray(rot), jnp.asarray(campos)),
          REORDERED)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = rot
    c2w[:3, 3] = campos
    intr = f32([[50, 0, 32], [0, 50, 24], [0, 0, 1]])
    pxy, dep = tcam.w2iproject(tt(x), tt(intr), tt(c2w))
    jxy, jdep = jcam.w2iproject(jnp.asarray(x), jnp.asarray(intr),
                                jnp.asarray(c2w))
    close(pxy, jxy, dict(rtol=1e-5, atol=1e-4))
    close(dep, jdep, REORDERED)
    other = f32([1.0, -0.5, -2.0])
    close(tcam.delta_viewdirs(tt(x), tt(campos), tt(other)),
          jcam.delta_viewdirs(jnp.asarray(x), jnp.asarray(campos),
                              jnp.asarray(other)), REORDERED)
    pnt = f32(r.uniform(1, 2, (4, 5, 3, 3)))
    loc = f32(r.uniform(1, 2, (4, 5, 3)))
    close(tcam.pers_delta(tt(pnt), tt(loc)),
          jcam.pers_delta(jnp.asarray(pnt), jnp.asarray(loc)), EXACT)


@pytest.mark.parametrize("render,blend,tone", [
    ("radiance", "alpha", "off"), ("radiance", "alpha2", "gamma"),
    ("white", "alpha", "normalize")])
def test_ray_march(render, blend, tone):
    r = rng(3)
    feats = f32(r.normal(size=(7, 9, 4)))
    dist = f32(r.uniform(0.0, 0.05, (7, 9)))
    valid = r.random((7, 9)) < 0.7
    bg = f32([1.0, 0.5, 0.0])
    out = tmarch.ray_march(tt(dist), tt(valid), tt(feats),
                           tmarch.RENDER_FUNCS[render],
                           tmarch.BLEND_FUNCS[blend], tt(bg))
    ref = jmarch.ray_march(jnp.asarray(dist), jnp.asarray(valid),
                           jnp.asarray(feats), jmarch.RENDER_FUNCS[render],
                           jmarch.BLEND_FUNCS[blend], jnp.asarray(bg))
    for o, e in zip(out, ref):
        close(o, e, REORDERED)
    close(tmarch.TONEMAP_FUNCS[tone](out[0]),
          jmarch.TONEMAP_FUNCS[tone](ref[0]), REORDERED)


@pytest.mark.parametrize("mode_unit", [True, False])
def test_ray_dist_from_depth(mode_unit):
    r = rng(4)
    depth = f32(np.cumsum(r.uniform(-0.01, 0.05, (6, 12)), axis=-1) + 1.0)
    depth[:, 3] = depth[:, 2]
    valid = r.random((6, 12)) < 0.8
    close(tmarch.ray_dist_from_depth(tt(depth), tt(valid), 0.016, mode_unit),
          jmarch.ray_dist_from_depth(jnp.asarray(depth), jnp.asarray(valid),
                                     0.016, mode_unit), EXACT)


def _mlp(dims, act, final_act, seed=0):
    tree = numpy_params(lambda k: jmlp.mlp_init(k, dims, act, final_act),
                        seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax.params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "sigmoid", "tanh"])
@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_apply(act, final_act):
    jl, tl = _mlp([12, 32, 32, 5], act, final_act)
    x = f32(rng(5).normal(size=(3, 4, 12)))
    close(tmlp.mlp_apply(tl, tt(x), act, final_act),
          jmlp.mlp_apply(jl, jnp.asarray(x), act, final_act), REORDERED)


def test_mlp_apply_split_broadcasts():
    jl, tl = _mlp([6 + 4 + 3, 16, 16], "leaky_relu", True)
    r = rng(6)
    a = f32(r.normal(size=(2, 5, 7, 6)))
    b = f32(r.normal(size=(1, 5, 7, 4)))
    c = f32(r.normal(size=(2, 5, 7, 3)))
    close(tmlp.mlp_apply_split(tl, [tt(a), tt(b), tt(c)], "leaky_relu",
                               True),
          jmlp.mlp_apply_split(jl, [jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(c)], "leaky_relu", True),
          REORDERED)


def test_split_rejects_wrong_width():
    _, tl = _mlp([10, 8], "relu", False)
    with pytest.raises(ValueError):
        tmlp.mlp_apply_split(tl, [torch.zeros(2, 4), torch.zeros(2, 4)],
                             "relu")


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_nhwc_hwio(stride):
    tree = numpy_params(lambda k: jmlp.conv2d_init(k, 3, 6, 3), 1)
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_jax.params_from_numpy(tree, device="cpu")
    x = f32(rng(7).normal(size=(2, 13, 10, 3)))
    close(tmlp.conv2d_apply(tp, tt(x), stride),
          jmlp.conv2d_apply(p, jnp.asarray(x), stride), REORDERED)


def test_bilinear_upsample():
    x = f32(rng(8).normal(size=(2, 6, 8, 5)))
    close(tmlp.bilinear_resize(tt(x), 48, 64),
          jmlp.bilinear_resize(jnp.asarray(x), 48, 64), REORDERED)


def test_feature_pyramid():
    tree = numpy_params(jfp.init, 2)
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_jax.params_from_numpy(tree, device="cpu")
    imgs = f32(rng(9).uniform(0, 1, (2, 16, 24, 3)))
    close(tfp.apply(tp, tt(imgs)), jfp.apply(p, jnp.asarray(imgs)),
          REORDERED)
