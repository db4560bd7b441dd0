"""The port's fused shading chain (ops/shading_chain.py) against the TPU
kernel it ports, tools/pallas_shading.py:fused_feat_alpha_pe, run in
interpret mode on the CPU and imported from tools/ as
tools/test_pallas_shading.py does.

Same numpy inputs, weights and cotangents go to both.  Tolerances:

- float32: rtol 2e-5 / atol 1e-5, the bound tools/test_pallas_shading.py
  holds the TPU kernel to; gradients compared after dividing by the largest
  magnitude of the reference gradient, as that file does (dW and db are sums
  over all rows).
- bfloat16: both round the same operands to bf16 and accumulate in f32, in
  another order, so a next layer's bf16 input can flip by one unit in the
  last place; held at ops/shading_chain.tolerance, a relative L2 error of
  2**-10 for feat, 2**-8 for alpha and 2**-5 for gradients, the bounds the
  kernels are held to against the plain version on the card (the reasons
  are in its docstring).  Each comparison prints its reading (pytest -s).
- the explicit backward against torch autograd of chain_plain (float32, the
  same products): rtol 1e-5 / atol 1e-6 of the largest magnitude.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.core import encoding as jenc
from hybridneuralrendering_tpu.models import mlp as jmlp
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.ops import shading_chain as SC

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import pallas_shading as PS  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".fixture", "ckpts", "roomsim_full", "ckpt",
    "2000_state.npz")
F32 = dict(rtol=2e-5, atol=1e-5)

# de, dd, fe, fd: raw embedding and dist widths and their PE bands; F the
# feature width; l1, l3 the block1 and block3 depths; head the alpha head's
# depth; ce the extra width; n rows (none a multiple of the 64-row tile but
# scannet_full's)
CASES = {
    "scannet_full": dict(de=32, dd=6, fe=3, fd=5, F=256, l1=2, l3=2, head=1,
                         ce=7, n=512),
    "tiny_test": dict(de=8, dd=6, fe=2, fd=2, F=128, l1=2, l3=2, head=1,
                      ce=7, n=300),
    "two_layer_head": dict(de=8, dd=6, fe=2, fd=2, F=64, l1=1, l3=1, head=2,
                           ce=7, n=200),
    "no_extra": dict(de=8, dd=3, fe=2, fd=3, F=64, l1=2, l3=1, head=1, ce=0,
                     n=131),
    "raw_dists": dict(de=8, dd=6, fe=0, fd=0, F=48, l1=1, l3=2, head=1, ce=4,
                      n=77),
}


def _cfg(c, dtype):
    return dataclasses.replace(
        TC.scannet_full().agg, point_features_dim=c["de"],
        num_feat_freqs=c["fe"], dist_xyz_freq=c["fd"],
        shading_feature_num=c["F"], shading_dtype=dtype)


def _np_params(c, rng):
    """Xavier-uniform numpy weights of the chain's shapes."""
    def stack(dims):
        out = []
        for a, b in zip(dims[:-1], dims[1:]):
            lim = np.sqrt(6.0 / (a + b))
            out.append({"w": rng.uniform(-lim, lim, (a, b)).astype(np.float32),
                        "b": rng.uniform(-0.1, 0.1, b).astype(np.float32)})
        return out
    F = c["F"]
    c1 = SC.pe_width(c["de"], c["dd"], c["fe"], c["fd"])
    return {"block1": stack([c1] + [F] * c["l1"]),
            "block3": stack([F + c["ce"]] + [F] * c["l3"]),
            "alpha": stack([F] + [F // 2] * (c["head"] - 1) + [1])}


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    n = c["n"]
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return dict(params=_np_params(c, rng), emb=0.5 * f(n, c["de"]),
                dists=0.5 * f(n, c["dd"]), extra=f(n, c["ce"]),
                dfeat=f(n, c["F"]), dalpha=f(n, 1))


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(x), tree)


def _pallas(p, emb, dists, extra, c, dtype):
    return PS.fused_feat_alpha_pe(p["block1"], p["block3"], p["alpha"], emb,
                                  dists, extra, c["fe"], c["fd"],
                                  compute_dtype=dtype, interpret=True)


_REFS = {}


def _reference(case, dtype):
    """The TPU kernel's (feat, alpha) and its VJP, once per case."""
    if (case, dtype) not in _REFS:
        c = CASES[case]
        a = _inputs(c)
        jp = jax.tree_util.tree_map(jnp.asarray, a["params"])
        out, vjp = jax.vjp(
            lambda p, e, d, x: _pallas(p, e, d, x, c, dtype), jp,
            jnp.asarray(a["emb"]), jnp.asarray(a["dists"]),
            jnp.asarray(a["extra"]))
        grads = vjp((jnp.asarray(a["dfeat"]), jnp.asarray(a["dalpha"])))
        _REFS[case, dtype] = (a, jax.tree_util.tree_map(np.asarray, out),
                              jax.tree_util.tree_map(np.asarray, grads))
    return _REFS[case, dtype]


def _close(got, want, dtype, what, output="grad"):
    got = got.detach().numpy()
    want = np.array(want)
    scale = max(float(np.abs(want).max()), 1e-6) if want.size else 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got / scale, want / scale, **F32,
                                   err_msg=what)
    else:
        err = SC.rel_l2(torch.as_tensor(got), torch.as_tensor(want))
        tol = SC.tolerance(dtype, output)
        print(f"{what}: relative L2 error {err:.3e} (limit {tol:.3e})")
        assert err <= tol, f"{what}: relative L2 error {err} > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_plain_matches_pallas_forward(case, dtype):
    a, (feat, alpha), _ = _reference(case, dtype)
    c = CASES[case]
    got_f, got_a = SC.chain_plain(
        torch.tensor(a["emb"]), torch.tensor(a["dists"]),
        torch.tensor(a["extra"]), _torch(a["params"]), _cfg(c, dtype), dtype)
    assert got_f.dtype == got_a.dtype == torch.float32
    _close(got_f, feat, dtype, "feat", "feat")
    _close(got_a, alpha, dtype, "alpha", "alpha")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_backward_plain_matches_pallas_vjp(case, dtype):
    a, _, (g_p, g_emb, g_dists, g_extra) = _reference(case, dtype)
    c = CASES[case]
    d_emb, d_dists, d_extra, g = SC.chain_backward_plain(
        torch.tensor(a["emb"]), torch.tensor(a["dists"]),
        torch.tensor(a["extra"]), _torch(a["params"]), _cfg(c, dtype), dtype,
        torch.tensor(a["dfeat"]), torch.tensor(a["dalpha"]))
    _close(d_emb, g_emb, dtype, "d_emb")
    _close(d_dists, g_dists, dtype, "d_dists")
    _close(d_extra, g_extra, dtype, "d_extra")
    for k, layers in g_p.items():
        for i, layer in enumerate(layers):
            for n_ in ("w", "b"):
                _close(g[k][i][n_], layer[n_], dtype, f"{k}/{i}/{n_}")


@pytest.mark.parametrize("case", ["tiny_test", "two_layer_head", "no_extra",
                                  "raw_dists"])
def test_chain_backward_plain_matches_autograd(case):
    """float32: the explicit backward equals torch autograd of chain_plain
    through the same products."""
    c = CASES[case]
    a = _inputs(c, seed=1)
    cfg = _cfg(c, "float32")
    p = jax.tree_util.tree_map(lambda x: torch.tensor(x, requires_grad=True),
                               a["params"])
    x = [torch.tensor(a[k], requires_grad=True)
         for k in ("emb", "dists", "extra")]
    feat, alpha = SC.chain_plain(*x, p, cfg, "float32")
    df, da = torch.tensor(a["dfeat"]), torch.tensor(a["dalpha"])
    leaves = jax.tree_util.tree_leaves(p)
    auto = torch.autograd.grad((feat * df).sum() + (alpha * da).sum(),
                               x + leaves)
    *dx, g = SC.chain_backward_plain(*[t.detach() for t in x],
                                     jax.tree_util.tree_map(
                                         lambda t: t.detach(), p), cfg,
                                     "float32", df, da)
    for got, want in zip(dx + jax.tree_util.tree_leaves(g), auto):
        assert got.shape == want.shape
        scale = max(float(want.abs().max()), 1e-6) if want.numel() else 1.0
        torch.testing.assert_close(got / scale, want / scale, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_function_on_cpu_runs_the_plain_versions(dtype):
    """FusedFeatAlpha on CPU tensors: its outputs are chain_plain's and its
    gradients (inputs, every weight and bias) chain_backward_plain's."""
    c = CASES["two_layer_head"]
    a = _inputs(c, seed=2)
    cfg = _cfg(c, dtype)
    p = jax.tree_util.tree_map(lambda x: torch.tensor(x, requires_grad=True),
                               a["params"])
    x = [torch.tensor(a[k], requires_grad=True)
         for k in ("emb", "dists", "extra")]
    feat, alpha = SC.fused_feat_alpha(p, cfg, *x)
    df, da = torch.tensor(a["dfeat"]), torch.tensor(a["dalpha"])
    leaves = jax.tree_util.tree_leaves(p)
    got = torch.autograd.grad((feat * df).sum() + (alpha * da).sum(),
                              x + leaves)
    det = jax.tree_util.tree_map(lambda t: t.detach(), p)
    want_f, want_a = SC.chain_plain(*[t.detach() for t in x], det, cfg, dtype)
    *dx, g = SC.chain_backward_plain(*[t.detach() for t in x], det, cfg,
                                     dtype, df, da)
    assert torch.equal(feat, want_f) and torch.equal(alpha, want_a)
    for a_, b_ in zip(got, dx + jax.tree_util.tree_leaves(g)):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["scannet_full", "no_extra",
                                  "two_layer_head"])
def test_pack_chain_round_trip(case, dtype):
    """The forward half of the packed weights, unpacked, gives the
    parameters back (bf16-rounded in bf16); the W^T half is its transpose;
    padding is zero."""
    c = CASES[case]
    p = _torch(_inputs(c)["params"])
    layout = SC.chain_layout(p, _cfg(c, dtype), c["de"], c["dd"], c["ce"])
    dt = SC.COMPUTE_DTYPES[dtype]
    w, b = SC.pack_chain(p, layout, dt)
    assert w.dtype == dt and b.dtype == torch.float32
    assert w.numel() == 2 * layout.wtot and b.numel() == layout.btot
    back = SC.unpack_chain(torch.cat([w[:layout.wtot].float(), b]), layout)
    for s, want, got in zip(layout.layers, SC._layer_list(p), back):
        assert torch.equal(got["w"], want["w"].to(dt).float())
        assert torch.equal(got["b"], want["b"])
        wp = w[s.woff:s.woff + s.kp * s.np].view(s.kp, s.np)
        wt = w[s.wtoff:s.wtoff + s.kp * s.np].view(s.np, s.kp)
        assert torch.equal(wt, wp.t())
        assert float(wp.float().abs().sum()) == pytest.approx(
            float(want["w"].to(dt).float().abs().sum()), rel=1e-6)
        assert s.kp % 16 == 0 and s.np % 16 == 0 and s.woff % 256 == 0


def _stage_passes(n):
    """The bf16 kernels' passes over n output columns, (first column,
    width): 32 columns, 256, or the 32 past 256 and then the first 256."""
    if n <= 32:
        return [(0, 32)]
    return [(0, 256)] if n <= 256 else [(256, 32), (0, 256)]


@pytest.mark.parametrize("case", ["scannet_full", "tiny_test",
                                  "two_layer_head", "raw_dists"])
def test_stage_images_unswizzle_to_plain_layouts(case):
    """stage_images, built on the CPU and un-swizzled by the hardware's
    128-byte rule (the byte address 128 n + 2 k of element (n, k) of a
    stage, its bits 4-6 XORed with bits 7-9), gives back product by product
    the padded W [kp, np] of pack_chain (forward) and its W^T [np, kp]
    (backward, last layer first), zeros in every padded row and column, and
    nothing else.  tiny_test is ragged: block3's 135 inputs pad to 144, a
    K tail of 16 in the last 64-row stage."""
    c = CASES[case]
    p = _torch(_inputs(c)["params"])
    layout = SC.chain_layout(p, _cfg(c, "bfloat16"), c["de"], c["dd"],
                             c["ce"])
    w, _ = SC.pack_chain(p, layout, torch.bfloat16)
    img = SC.stage_images(w, layout)
    assert img.dtype == torch.bfloat16
    n = torch.arange(256)[:, None]
    k = torch.arange(64)[None, :]
    addr = 128 * n + 2 * k
    elem = (addr ^ (((addr >> 7) & 7) << 4)) // 2      # [256, 64]
    plain = [(w[s.woff:s.woff + s.kp * s.np].view(s.kp, s.np), s)
             for s in layout.layers]
    products = ([(wp, s.kp, s.np) for wp, s in plain]
                + [(wp.t(), s.np, s.kp) for wp, s in reversed(plain)])
    off = 0
    for want, K, N in products:
        kpad = -(-K // 64) * 64
        got = torch.full((kpad, 288), float("nan"))
        for n0, nw in _stage_passes(N):
            for k0 in range(0, K, 64):
                stage = img[off:off + nw * 64].float()
                off += nw * 64
                got[k0:k0 + 64, n0:n0 + nw] = stage[elem[:nw]].t()
        cover = max(n0 + nw for n0, nw in _stage_passes(N))
        assert torch.equal(got[:K, :N], want.float())
        assert not got[K:, :N].any() and not got[:, N:cover].any()
    assert off == img.numel()


def test_scannet_full_layout():
    """The packed layout at the scannet_full widths: padded input widths
    288, 256, 272 (256 + the 7 extra columns), 256, 256; 271,360
    multiply-adds a row; 13 head ints and 8 per layer for the kernels."""
    c = CASES["scannet_full"]
    p = _torch(_inputs(c)["params"])
    layout = SC.chain_layout(p, _cfg(c, "bfloat16"), 32, 6, 7)
    assert [s.kp for s in layout.layers] == [288, 256, 272, 256, 256]
    assert [s.np for s in layout.layers] == [256, 256, 256, 256, 16]
    assert layout.layers[2].extra_at == (256, 256)
    assert sum(s.kin * s.nout for s in layout.layers) == 271_360
    assert len(layout.meta) == 13 + 8 * 5


def _layout(case, seed=0, dtype="bfloat16"):
    c = CASES[case]
    p = _torch(_inputs(c, seed)["params"])
    return SC.chain_layout(p, _cfg(c, dtype), c["de"], c["dd"], c["ce"])


def _dw_plan_parts(plan):
    """dw_plan's ints -> (items [(acol, gcol, rows, nw, np, out, db0, db1)],
    split bounds in 64-row stages)."""
    J, S = plan[:2]
    items = [plan[2 + 8 * j:10 + 8 * j] for j in range(J)]
    bounds = list(plan[2 + 8 * J:])
    assert len(bounds) == S + 1
    return items, bounds


@pytest.mark.parametrize("npad", [64, 64 * 13, 64 * 1_000, 602_112])
@pytest.mark.parametrize("case", ["scannet_full", "tiny_test"])
def test_dw_plan_covers_each_weight_and_row_once(case, npad):
    """The bf16 chain_dw's plan: in every row split, each (layer, dW row,
    column) and each db column belongs to exactly one item, each item reads
    its own layer's A columns (aoff + its first dW row) and G columns, in
    64- or 256-wide wgmmas of at most 128 dW rows; the splits cut the
    npad / 64 stages into S = DW_ITEMS // J non-empty, contiguous pieces
    (so each scratch row is summed exactly once for each layer); the plan
    is the same for another layout of the same shapes.  tiny_test is
    ragged: block1's 64 inputs, block3's 135 padded to 144."""
    layout = _layout(case)
    plan = SC.dw_plan(layout, npad)
    assert plan == SC.dw_plan(_layout(case, seed=1), npad)
    items, bounds = _dw_plan_parts(plan)
    stages = npad // 64
    assert plan[1] == max(1, min(stages, SC.DW_ITEMS // len(items)))
    assert bounds[0] == 0 and bounds[-1] == stages
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert max(np.diff(bounds)) - min(np.diff(bounds)) <= 1
    count = torch.zeros(layout.wtot + layout.btot, dtype=torch.int32)
    for acol, gcol, rows, nw, np_, out, db0, db1 in items:
        slot = next(s for s in layout.layers
                    if s.woff <= out < s.woff + s.kp * s.np)
        k0 = (out - slot.woff) // slot.np
        assert out == slot.woff + k0 * slot.np and acol == slot.aoff + k0
        assert gcol == slot.goff and np_ == slot.np
        assert 0 < rows <= SC.DW_SLAB and k0 + rows <= slot.kp
        assert nw == (64 if slot.np <= 64 else 256)
        count[out:out + rows * np_] += 1
        count[layout.wtot + db0:layout.wtot + db1] += 1
    assert torch.equal(count, torch.ones_like(count))


def _dw_order_model(layout, ascr, gscr, dbpart):
    """The bf16 chain_dw's order of sums on the CPU: per row split of
    dw_plan and per item, a float32 running sum over the split's 64-row
    stages of A_stage^T G_stage (the stage's own products in float32), db
    the split's partials in row order; then the splits in order."""
    items, bounds = _dw_plan_parts(SC.dw_plan(layout, ascr.shape[0]))
    A, G = ascr.float(), gscr.float()
    width = layout.wtot + layout.btot
    total = torch.zeros(width)
    for lo, hi in zip(bounds, bounds[1:]):
        part = torch.zeros(width)
        for acol, gcol, rows, _, np_, out, db0, db1 in items:
            acc = torch.zeros(rows, np_)
            for t in range(lo, hi):
                r = slice(64 * t, 64 * t + 64)
                acc += A[r, acol:acol + rows].t() @ G[r, gcol:gcol + np_]
            part[out:out + rows * np_] = acc.reshape(-1)
            db = torch.zeros(db1 - db0)
            for t in range(lo, hi):
                db += dbpart[t, db0:db1]
            part[layout.wtot + db0:layout.wtot + db1] = db
        total += part
    return total


@pytest.mark.parametrize("case", ["scannet_full", "tiny_test"])
def test_dw_order_model_matches_plain(case):
    """The kernel's order of float32 sums (_dw_order_model) over bf16
    scratch of 64 * 13 rows (eleven splits of one or two stages) against
    the plain A^T G and db sum, per layer and for db, within the bf16
    gradient tolerance (and the float32 one, 2**-16: only the order of the
    f32 sums differs)."""
    layout = _layout(case)
    npad = 64 * 13
    rng = np.random.default_rng(7)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731,E501
    ascr = f(npad, layout.atot).to(torch.bfloat16)
    gscr = (1e-2 * f(npad, layout.gtot)).to(torch.bfloat16)
    dbpart = f(npad // 64, layout.btot)
    got = _dw_order_model(layout, ascr, gscr, dbpart)
    for s in layout.layers:
        want = (ascr[:, s.aoff:s.aoff + s.kp].float().t()
                @ gscr[:, s.goff:s.goff + s.np].float())
        err = SC.rel_l2(got[s.woff:s.woff + s.kp * s.np], want.reshape(-1))
        assert err <= SC.tolerance("float32", "grad"), (s.key, err)
        assert err <= SC.tolerance("bfloat16", "grad")
    err = SC.rel_l2(got[layout.wtot:], dbpart.sum(0))
    assert err <= SC.tolerance("float32", "grad")


def test_chain_layout_rejects_bad_shapes():
    c = CASES["tiny_test"]
    p = _torch(_inputs(c)["params"])
    cfg = _cfg(c, "float32")
    with pytest.raises(ValueError):
        SC.chain_layout(p, cfg, c["de"], c["dd"], c["ce"] + 1)
    with pytest.raises(ValueError):
        SC.chain_layout({k: v for k, v in p.items() if k != "block3"}, cfg,
                        c["de"], c["dd"], c["ce"])
    with pytest.raises(ValueError):
        SC.chain_plain(torch.zeros(2, 8), torch.zeros(2, 6),
                       torch.zeros(2, 7), p, cfg, "float16")


def test_chain_kernels_never_fall_back():
    """Tensors that are not on the CPU go to the kernels, which take only
    CUDA tensors: anything else raises."""
    c = CASES["tiny_test"]
    p = _torch(_inputs(c)["params"])
    layout = SC.chain_layout(p, _cfg(c, "bfloat16"), c["de"], c["dd"],
                             c["ce"])
    meta = lambda *s: torch.empty(*s, device="meta")     # noqa: E731
    with pytest.raises(ValueError):
        SC.chain_forward(layout, meta(2 * layout.wtot), meta(layout.btot),
                         meta(10, 8), meta(10, 6), meta(10, 7))


def test_aggregator_rejects_chain_without_block3():
    cfg = dataclasses.replace(TC.tiny_test().agg,
                              shading_feature_mlp_layer3=0)
    with pytest.raises(NotImplementedError, match="block3"):
        tagg._check_supported(cfg)


def test_params_from_numpy_carries_the_chain_unchanged():
    """The chain keeps the JAX layout: io.from_jax hands its weights over
    as they are, and the layout reads them without reshuffling."""
    c = CASES["scannet_full"]
    tree = _inputs(c)["params"]
    got = from_jax.params_from_numpy(tree, device="cpu")
    for k, layers in tree.items():
        for i, layer in enumerate(layers):
            for n_ in ("w", "b"):
                np.testing.assert_array_equal(got[k][i][n_].numpy(),
                                              layer[n_])
    SC.chain_layout(got, _cfg(c, "bfloat16"), 32, 6, 7)


# ------------------------------------------------------ trained-weight anchor

def _jax_chain(p, emb, dists, extra, fe, fd, dtype):
    """The JAX package's shipped chain (models/aggregator.apply's chain_fn
    before the K-sum), from its own encoding and mlp modules: under bf16 one
    cast of inputs and weights at entry, bf16 end to end."""
    ft = jnp.concatenate([emb, jenc.positional_encoding(emb, fe)], -1)
    ft = jnp.concatenate([ft, jenc.positional_encoding(dists, fd)], -1)
    if dtype == "bfloat16":
        ft = ft.astype(jnp.bfloat16)
        extra = extra.astype(jnp.bfloat16)
        p = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), p)
    ft = jmlp.mlp_apply(p["block1"], ft, "leaky_relu", final_act=True)
    ft = jmlp.mlp_apply(p["block3"], jnp.concatenate([ft, extra], -1),
                        "leaky_relu", final_act=True)
    a = jnp.einsum("...c,c->...", ft, p["alpha"][0]["w"][:, 0])
    a = a + p["alpha"][0]["b"][0]
    return ft.astype(jnp.float32), a.astype(jnp.float32)[:, None]


def test_trained_weight_anchor():
    """The trained scannet_full-width chain of the fixture checkpoint on
    realistic inputs: trained point embeddings, neighbour offsets of the
    query radius (4 voxels of 8 mm, world and camera-space deltas; a third
    of the slots empty, zero), colours in [0, 1] and unit-vector deltas.
    The port's bf16 chain matches the TPU kernel's bf16 output within
    ops/shading_chain.tolerance, and is no farther from the JAX float32
    chain than the JAX package's shipped bf16 chain is."""
    if not os.path.exists(FIXTURE):
        pytest.skip("the fixture checkpoint is not in this checkout")
    z = np.load(FIXTURE)
    p = {k: [{n_: z[f"params/aggregator/{k}/{i}/{n_}"] for n_ in ("w", "b")}
             for i in range(2 if k != "alpha" else 1)]
         for k in ("block1", "block3", "alpha")}
    n = 3000
    rng = np.random.default_rng(0)
    emb = z["points/embedding"][rng.choice(400_000, n, replace=False)]
    emb = emb.astype(np.float32)
    radius = 4 * 0.008
    dists = rng.uniform(-radius, radius, (n, 6)).astype(np.float32)
    empty = rng.random(n) < 1 / 3
    dists[empty] = 0.0
    color = rng.random((n, 3)).astype(np.float32)
    pdir = rng.normal(size=(n, 3))
    vdir = rng.normal(size=(n, 3))
    pdir /= np.linalg.norm(pdir, axis=1, keepdims=True)
    vdir /= np.linalg.norm(vdir, axis=1, keepdims=True)
    extra = np.concatenate([color, pdir - vdir,
                            np.sum(pdir * vdir, 1, keepdims=True)],
                           1).astype(np.float32)
    cfg = TC.scannet_full().agg
    fe, fd = cfg.num_feat_freqs, cfg.dist_xyz_freq
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    je, jd, jx = jnp.asarray(emb), jnp.asarray(dists), jnp.asarray(extra)
    tpu = _pallas(jp, je, jd, jx, dict(fe=fe, fd=fd), "bfloat16")
    ref32 = _jax_chain(jp, je, jd, jx, fe, fd, "float32")
    ship16 = _jax_chain(jp, je, jd, jx, fe, fd, "bfloat16")
    port = SC.chain_plain(torch.tensor(emb), torch.tensor(dists),
                          torch.tensor(extra), _torch(p), cfg, "bfloat16")
    for i, name in enumerate(("feat", "alpha")):
        got = port[i]
        to_tpu = SC.rel_l2(got, torch.tensor(np.asarray(tpu[i])))
        tol = SC.tolerance("bfloat16", name)
        f32 = torch.tensor(np.asarray(ref32[i]))
        ship = torch.tensor(np.asarray(ship16[i]))
        d_port = (float((got - f32).abs().max()), SC.rel_l2(got, f32))
        d_ship = (float((ship - f32).abs().max()), SC.rel_l2(ship, f32))
        msg = (f"{name}: port bf16 vs TPU kernel bf16, relative L2 "
               f"{to_tpu:.3e} (limit {tol:.3e}); distance from the JAX f32 "
               f"chain (max abs, relative L2): port bf16 {d_port}, JAX "
               f"shipped bf16 {d_ship}")
        print(msg)
        assert to_tpu <= tol, msg
        assert d_port[0] <= d_ship[0] and d_port[1] <= d_ship[1], msg
