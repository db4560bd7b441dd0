"""The per-neighbour shading chain: block1 (+ block2) -> block3 -> alpha head,
with the positional encoding built inside, forward and backward.

`fused_feat_alpha` is the port of the Pallas TPU kernel
`tools/pallas_shading.py:fused_feat_alpha_pe` and its recompute VJP.  On
CUDA tensors it launches the hand-written kernels of `csrc/shading_chain.cu`
(`chain_fwd`; in the backward `chain_bwd` and `chain_dw`); in bf16 the
first two read the weights as `stage_images`, each chunk laid out as the
shared-memory image their `wgmma` products read, and `chain_dw` sums the
backward's scratch by the row splits of `dw_plan`.  On
CPU tensors it runs `chain_plain` and `chain_backward_plain`, which follow
the TPU kernel's arithmetic: the operands of every product are rounded to
the compute type (bf16 or f32), products accumulate in f32, and bias, leaky
ReLU (slope 0.01) and the encoding are f32.  The block1 input keeps the
reference's d-major interleaved sin/cos layout (core/encoding), so the
weights keep the JAX layout; the TPU's 128-lane padding and its
frequency-major permutation are not carried over.

Kernel against plain version (`tolerance`, a relative L2 error per
output): both round the same operands to bf16, but the kernel adds each
product in another order in f32, so a next layer's bf16 input can differ by
one unit in the last place and the difference passes through the rest of
the chain.  Float32 compute differs only by the order of the f32 sums.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from hybridneuralrendering_tpu_torch.config import AggregatorConfig
from hybridneuralrendering_tpu_torch.core.encoding import positional_encoding

SLOPE = 0.01
TILE = 64           # rows of a db partial; the backward pads rows to it
ALIGN = 16          # every padded width (one mma tile edge)
CHUNK_ROWS = 4096   # rows of a float32 chain_dw partial sum (kF32ChunkRows)
# the bf16 chain_dw (csrc/shading_chain.cu hop::dw_hop): an item is DW_SLAB
# rows of one layer's dW (kDwSlab: two consumer warpgroups of 64); the rows
# of the scratch are cut into as many splits as make about DW_ITEMS items,
# one per SM of an H100 (132 SMs) in one wave.  DW_ITEMS is a constant, not
# the card's SM count, so the order of the sums, and their bits, follow from
# the shapes alone.
DW_SLAB, DW_ITEMS = 128, 132
# the bf16 kernels' weight stages: CHUNK_K rows of K by a pass of WIDE or
# NARROW output columns (csrc/shading_chain.cu hop::kChunkK, kWide, kNarrow)
CHUNK_K, WIDE, NARROW = 64, 256, 32
# shared library name -> its sources under csrc/
KERNEL_LIBS = {"shading_chain": ["shading_chain.cu"]}
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rup(x: int, m: int = ALIGN) -> int:
    return -(-x // m) * m


def _lrelu(x):
    return torch.where(x >= 0, x, SLOPE * x)


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    """One Linear of the chain in the packed layout: its padded input and
    output widths (kp, np), real widths, and offsets into the packed
    weights (w at woff as [kp, np], W^T at wtoff as [np, kp]), biases,
    and the backward's A and G scratch rows."""
    key: Tuple[str, int]
    kin: int
    nout: int
    kp: int
    np: int
    woff: int
    wtoff: int
    boff: int
    aoff: int
    goff: int
    extra_at: Optional[Tuple[int, int]]   # B bottom: (F real, F padded)


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    """The packed layout of one chain's parameters for the kernels."""
    layers: Tuple[LayerSlot, ...]
    na: int
    nb: int
    de: int
    dd: int
    ce: int
    fe: int
    fd: int
    c1: int
    atot: int
    gtot: int
    btot: int
    wtot: int

    @property
    def meta(self) -> List[int]:
        """The ints the C functions read (csrc/shading_chain.cu read_meta)."""
        head = [len(self.layers), self.na, self.nb, self.de, self.dd,
                self.ce, self.fe, self.fd, self.c1, self.atot, self.gtot,
                self.btot, self.wtot]
        for s in self.layers:
            head += [s.kp, s.np, s.nout, s.woff, s.wtoff, s.boff, s.aoff,
                     s.goff]
        return head


def chain_stacks(params: Dict) -> Tuple[List, List, List]:
    """(A, B, head) lists of ((stack, index), layer) of the chain params;
    raises unless each is there (the fused chain needs them all)."""
    a = [((k, i), p) for k in ("block1", "block2") if k in params
         for i, p in enumerate(params[k])]
    b = [(("block3", i), p) for i, p in enumerate(params.get("block3", []))]
    h = [(("alpha", i), p) for i, p in enumerate(params.get("alpha", []))]
    if not a or not b or not h:
        raise ValueError("the fused chain needs block1, block3 and an alpha "
                         "head")
    return a, b, h


def pe_width(de: int, dd: int, fe: int, fd: int) -> int:
    return de + 2 * fe * de + (2 * fd * dd if fd else dd)


def chain_layout(params: Dict, cfg: AggregatorConfig, de: int, dd: int,
                 ce: int) -> ChainLayout:
    """The layout of `params` ({"block1", ["block2"], "block3", "alpha"}:
    lists of {"w": [in, out], "b": [out]}) for raw inputs of widths de
    (embedding), dd (dists) and ce (extra)."""
    a, b, h = chain_stacks(params)
    fe, fd = cfg.num_feat_freqs, abs(cfg.dist_xyz_freq)
    c1 = pe_width(de, dd, fe, fd)
    slots = []
    kp_in = _rup(c1)
    kin_want = c1
    woff = boff = aoff = goff = 0
    layers = a + b + h
    for i, (key, p) in enumerate(layers):
        kin, nout = p["w"].shape
        extra_at = None
        if i == len(a):
            f_real = kin_want
            extra_at = (f_real, slots[-1].np)
            kin_want = f_real + ce
            kp_in = _rup(slots[-1].np + ce)
        if kin != kin_want or p["b"].shape != (nout,):
            raise ValueError(f"chain layer {key}: w {tuple(p['w'].shape)}, "
                             f"b {tuple(p['b'].shape)}; expected {kin_want} "
                             "inputs")
        np_ = _rup(nout)
        slots.append(LayerSlot(key, kin, nout, kp_in, np_, woff, 0, boff,
                               aoff, goff, extra_at))
        woff += kp_in * np_
        boff += np_
        aoff += kp_in
        goff += np_
        kp_in, kin_want = np_, nout
    wtot = woff
    wt = wtot
    for j, s in enumerate(slots):
        slots[j] = dataclasses.replace(s, wtoff=wt)
        wt += s.kp * s.np
    return ChainLayout(tuple(slots), len(a), len(b), de, dd, ce, fe, fd, c1,
                       aoff, goff, boff, wtot)


def _layer_list(params: Dict) -> List[Dict]:
    a, b, h = chain_stacks(params)
    return [p for _, p in a + b + h]


def _pad_weight(s: LayerSlot, w: torch.Tensor) -> torch.Tensor:
    out = w.new_zeros((s.kp, s.np))
    if s.extra_at is None:
        out[:s.kin, :s.nout] = w
    else:
        f, fp = s.extra_at
        out[:f, :s.nout] = w[:f]
        out[fp:fp + s.kin - f, :s.nout] = w[f:]
    return out


def _unpad_weight(s: LayerSlot, wp: torch.Tensor) -> torch.Tensor:
    if s.extra_at is None:
        return wp[:s.kin, :s.nout]
    f, fp = s.extra_at
    return torch.cat([wp[:f, :s.nout], wp[fp:fp + s.kin - f, :s.nout]])


def pack_chain(params: Dict, layout: ChainLayout,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w, b): one `dtype` buffer holding every layer's zero-padded weight
    [kp, np] at its woff and its transpose [np, kp] at its wtoff, and one
    f32 buffer of the zero-padded biases."""
    layers = _layer_list(params)
    wp = [_pad_weight(s, p["w"].detach().float())
          for s, p in zip(layout.layers, layers)]
    w = torch.cat([x.reshape(-1) for x in wp]
                  + [x.t().reshape(-1) for x in wp]).to(dtype)
    b = torch.cat([torch.nn.functional.pad(p["b"].detach().float(),
                                           (0, s.np - s.nout))
                   for s, p in zip(layout.layers, layers)])
    return w, b


def unpack_chain(flat: torch.Tensor, layout: ChainLayout) -> List[Dict]:
    """The flat f32 [wtot + btot] buffer (the padded weights in the woff
    layout, then the padded biases) -> one {"w", "b"} per chain layer, in
    the parameters' shapes.  The backward's packed gradient has this
    layout, and so does the forward half of pack_chain's (w, b)."""
    out = []
    for s in layout.layers:
        wp = flat[s.woff:s.woff + s.kp * s.np].view(s.kp, s.np)
        b = flat[layout.wtot + s.boff:layout.wtot + s.boff + s.nout]
        out.append({"w": _unpad_weight(s, wp), "b": b})
    return out


def nest_like(params: Dict, flat_layers: Sequence) -> Dict:
    """Per-layer values in chain order -> the chain params' nesting."""
    it = iter(flat_layers)
    a, b, h = chain_stacks(params)
    out: Dict = {}
    for (k, _), _p in a + b + h:
        out.setdefault(k, []).append(next(it))
    return out


def _passes(n: int) -> List[Tuple[int, int]]:
    """(first column, width) of each pass of a product with n output
    columns, in the bf16 kernels' order (csrc/shading_chain.cu
    hop::npasses, pass_nw): one pass of NARROW columns (n <= NARROW) or of
    WIDE, or the NARROW columns past WIDE first, then WIDE."""
    if n <= NARROW:
        return [(0, NARROW)]
    if n <= WIDE:
        return [(0, WIDE)]
    return [(WIDE, NARROW), (0, WIDE)]


def image_products(layout: ChainLayout) -> List[Tuple[LayerSlot, int, int,
                                                      bool]]:
    """(slot, K, N, transposed) of every product whose weights the bf16
    kernels stream, in the order of their stage images: each layer's
    forward product (B = W [kp, np]) in chain order, then the backward's
    dX = G W^T (B = W^T [np, kp]) from the last layer to the first."""
    return ([(s, s.kp, s.np, False) for s in layout.layers]
            + [(s, s.np, s.kp, True) for s in reversed(layout.layers)])


@functools.lru_cache(maxsize=16)
def _image_index(layout: ChainLayout, device: torch.device) -> torch.Tensor:
    """For every element of the stage images, its index in pack_chain's w
    with one zero appended at wtot (the padding)."""
    n = torch.arange(WIDE)[:, None]
    k = torch.arange(CHUNK_K)[None, :]
    # element (n, k) of a stage: row n of 128 bytes, its 16-byte units of 8
    # k's XOR-swizzled by n % 8 (wgmma's 128-byte swizzle, K-major)
    pos = n * CHUNK_K + ((k // 8) ^ (n % 8)) * 8 + k % 8
    parts = []
    for s, K, N, transposed in image_products(layout):
        for n0, nw in _passes(N):
            for k0 in range(0, K, CHUNK_K):
                kk, nn = k0 + k, n0 + n[:nw]
                src = s.woff + (nn * s.np + kk if transposed
                                else kk * s.np + nn)
                src = torch.where((kk < K) & (nn < N), src, layout.wtot)
                img = torch.empty(nw * CHUNK_K, dtype=torch.long)
                img[pos[:nw].reshape(-1)] = src.reshape(-1)
                parts.append(img)
    return torch.cat(parts).to(device)


def stage_images(w: torch.Tensor, layout: ChainLayout) -> torch.Tensor:
    """The weights as the bf16 kernels read them, from pack_chain's w: for
    each product of image_products, each pass of _passes(N) and each chunk
    of CHUNK_K rows of K, one stage image [nw, CHUNK_K] of B^T (K-major),
    zero-padded, its 16-byte units swizzled as wgmma's 128-byte swizzle
    reads them, so that the kernels copy a stage as one block."""
    idx = _image_index(layout, w.device)
    return torch.cat([w[:layout.wtot], w.new_zeros(1)])[idx]


@functools.lru_cache(maxsize=32)
def dw_plan(layout: ChainLayout, npad: int) -> Tuple[int, ...]:
    """The bf16 chain_dw's work over npad scratch rows (a multiple of TILE),
    as the ints csrc/shading_chain.cu read_dw_plan takes:
    [J, S, J items of 8 ints, S + 1 split bounds].

    Items of one split, layer by layer: (acol, gcol, rows, nw, np, out, db0,
    db1) = dW rows [k0, k0 + rows) of the layer (rows <= DW_SLAB), read from
    scratch columns acol = aoff + k0 of A and goff of G, all np columns in
    wgmmas nw = 64 (np <= 64) or 256 wide, written at out = woff + k0 np of
    the packed gradient; db columns [db0, db1) are summed by the item's
    block.  S = DW_ITEMS // J splits (at most one per 64-row stage, at least
    one); split s takes the stages [bounds[s], bounds[s + 1]), as even as
    whole stages allow."""
    stages = npad // TILE
    items = []
    for s in layout.layers:
        nw = 64 if s.np <= 64 else WIDE
        for k0 in range(0, s.kp, DW_SLAB):
            items.append([s.aoff + k0, s.goff, min(DW_SLAB, s.kp - k0), nw,
                          s.np, s.woff + k0 * s.np])
    J = len(items)
    S = max(1, min(stages, DW_ITEMS // J))
    for j, item in enumerate(items):
        item += [j * layout.btot // J, (j + 1) * layout.btot // J]
    bounds = [i * stages // S for i in range(S + 1)]
    return tuple([J, S] + [v for item in items for v in item] + bounds)


def _kernel_weights(layout: ChainLayout, w: torch.Tensor) -> torch.Tensor:
    """What chain_fwd and chain_bwd take as `w`: the stage images in bf16,
    pack_chain's w in float32."""
    return stage_images(w, layout) if w.dtype == torch.bfloat16 else w


# ------------------------------------------------------------ plain versions

def expand_pe(emb: torch.Tensor, dists: torch.Tensor, fe: int,
              fd: int) -> torch.Tensor:
    """[N, de], [N, dd] -> the block1 input [emb | PE(emb) | PE(dists)]
    (dists raw when fd == 0), in the d-major sin/cos interleaved layout of
    core/encoding.positional_encoding."""
    parts = [emb]
    if fe > 0:
        parts.append(positional_encoding(emb, fe))
    parts.append(positional_encoding(dists, fd) if fd > 0 else dists)
    return torch.cat(parts, -1)


def _pe_backward(dx1: torch.Tensor, emb: torch.Tensor, dists: torch.Tensor,
                 fe: int, fd: int):
    """Cotangent of expand_pe, summed as the TPU kernel's `_pe_backward`:
    the raw part, then the sin terms band by band, then the cos terms."""
    de, dd = emb.shape[1], dists.shape[1]

    def back(raw_grad, x, enc, f):
        g = raw_grad
        enc = enc.reshape(x.shape[0], x.shape[1], f, 2)
        for j in range(f):
            g = g + (2.0 ** j) * torch.cos(x * 2.0 ** j) * enc[:, :, j, 0]
        for j in range(f):
            g = g - (2.0 ** j) * torch.sin(x * 2.0 ** j) * enc[:, :, j, 1]
        return g

    d_emb = dx1[:, :de]
    off = de
    if fe > 0:
        d_emb = back(d_emb, emb, dx1[:, off:off + 2 * fe * de], fe)
        off += 2 * fe * de
    if fd == 0:
        d_dists = dx1[:, off:off + dd]
    else:
        d_dists = back(torch.zeros_like(dists), dists,
                       dx1[:, off:off + 2 * fd * dd], fd)
    return d_emb, d_dists


def _mm(a, b, dt):
    """a @ b with operands rounded to dt and f32 accumulation (`_mm`)."""
    return a.to(dt).float() @ b.to(dt).float()


def _forward_sweep(x1, extra, layers, na, nb, dt):
    """(feat, alpha, pre-activations) of the chain on x1 [N, c1]."""
    pres = []
    h = x1
    L = len(layers)
    for i, p in enumerate(layers):
        if i == na:
            h = torch.cat([h, extra], -1)
        pre = _mm(h, p["w"], dt) + p["b"]
        pres.append(pre)
        h = _lrelu(pre) if i < L - 1 else pre
        if i == na + nb - 1:
            feat = h
    return feat, h, pres


def _dtype_name(name: str) -> str:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"the fused chain computes in float32 or bfloat16, "
                         f"not {name}")
    return name


def chain_dtype(cfg: AggregatorConfig) -> str:
    """The type the chain computes in, as JAX aggregator.py:312-313,
    397-405 picks it: shading_dtype when that is bfloat16, else
    compute_dtype when that is bfloat16, else float32.  JAX's
    compute_dtype chain rounds each product's operands to bf16 and keeps
    its sums, biases and activations in float32, which is how the bf16
    kernels round; only its single-Linear alpha head stays float32 there
    (alpha_head_is_f32)."""
    for name in (cfg.shading_dtype, cfg.compute_dtype):
        if _dtype_name(name) == "bfloat16":
            return name
    return "float32"


def alpha_head_is_f32(params: Dict, cfg: AggregatorConfig) -> bool:
    """True where JAX computes the chain's alpha head in float32 while the
    chain itself is bf16: compute_dtype bfloat16, shading_dtype float32
    and a single-Linear head (JAX aggregator.py:422-424 applies it as an
    f32 einsum outside the layers that round to compute_dtype)."""
    return (chain_dtype(cfg) == "bfloat16"
            and cfg.shading_dtype != "bfloat16"
            and len(params["alpha"]) == 1)


def alpha_head_f32(feat: torch.Tensor, head: Dict) -> torch.Tensor:
    """alpha_raw [N, 1] = feat @ w + b in float32: the single-Linear head
    of alpha_head_is_f32, a plain matvec as JAX's einsum; autograd gives
    dfeat = dalpha w^T, dW = feat^T dalpha and db = sum dalpha, all in
    float32."""
    return feat.float() @ head["w"].float() + head["b"].float()


def chain_plain(emb: torch.Tensor, dists: torch.Tensor, extra: torch.Tensor,
                layers: Dict, cfg: AggregatorConfig,
                compute_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feat [N, F] f32, alpha_raw [N, H] f32) of emb [N, de], dists [N, dd]
    and extra [N, ce]; `layers` the chain params."""
    a, b, _ = chain_stacks(layers)
    dt = COMPUTE_DTYPES[_dtype_name(compute_dtype)]
    x1 = expand_pe(emb.float(), dists.float(), cfg.num_feat_freqs,
                   abs(cfg.dist_xyz_freq))
    feat, alpha, _ = _forward_sweep(x1, extra.float(), _layer_list(layers),
                                    len(a), len(b), dt)
    return feat, alpha


def chain_backward_plain(emb, dists, extra, layers: Dict,
                         cfg: AggregatorConfig, compute_dtype: str,
                         dfeat: torch.Tensor, dalpha: torch.Tensor):
    """The recompute backward of chain_plain, as the TPU kernel's
    `_bwd_kernel`: (d_emb, d_dists, d_extra, grads in the params' nesting).
    Each dW is the f32 product of the compute-type-rounded layer input and
    cotangent; each db the f32 sum of the cotangent."""
    a, b, _ = chain_stacks(layers)
    na, nb = len(a), len(b)
    dt = COMPUTE_DTYPES[_dtype_name(compute_dtype)]
    fe, fd = cfg.num_feat_freqs, abs(cfg.dist_xyz_freq)
    emb, dists, extra = emb.float(), dists.float(), extra.float()
    x1 = expand_pe(emb, dists, fe, fd)
    plist = _layer_list(layers)
    L = len(plist)
    _, _, pres = _forward_sweep(x1, extra, plist, na, nb, dt)

    def layer_input(i):
        if i == 0:
            return x1
        prev = _lrelu(pres[i - 1])
        return torch.cat([prev, extra], -1) if i == na else prev

    grads: List[Dict] = [None] * L
    g = dalpha.float()
    d_extra = None
    for i in range(L - 1, -1, -1):
        if i < L - 1:
            g = g * torch.where(pres[i] >= 0, 1.0, SLOPE)
        grads[i] = {"w": _mm(layer_input(i).t(), g, dt),
                    "b": g.sum(0)}
        g = _mm(g, plist[i]["w"].t(), dt)
        if i == na + nb:
            g = g + dfeat.float()
        elif i == na:
            f = g.shape[1] - extra.shape[1]
            d_extra, g = g[:, f:], g[:, :f]
    d_emb, d_dists = _pe_backward(g, emb, dists, fe, fd)
    return d_emb, d_dists, d_extra, nest_like(layers, grads)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64 (0 when both are zero)."""
    d = float(torch.linalg.norm((got.double() - want.double()).reshape(-1)))
    r = float(torch.linalg.norm(want.double().reshape(-1)))
    return d / r if r > 0 else (0.0 if d == 0 else float("inf"))


# limits of `tolerance` in bf16, by output
BF16_LIMITS = {"feat": 2.0 ** -10, "alpha": 2.0 ** -8, "grad": 2.0 ** -5}


def tolerance(compute_dtype: str, output: str = "feat") -> float:
    """The largest relative L2 error (rel_l2) of one output of the kernels
    against the plain version, or of the plain version against the TPU
    kernel: "feat", "alpha", or "grad" (d_emb, d_dists, d_extra, each dW
    and db).  Float32: 2**-16, sums of a few hundred products in another
    order.

    Bf16: both round the same operands to bf16, but the f32 sums run in
    another order, so a next layer's bf16 input can flip by one unit in the
    last place (2**-8 of that element) and the flip passes through the
    following layers.  Each limit lies between that sound error and the
    error of a chain that rounds more (the bf16-end-to-end chain the kernels
    replace: activations, biases and each product's result in bf16), at
    least 2.8 times from each on the scannet_full widths (sound readings
    from tests/test_torch_port_shading.py under pytest -s and the chip
    smoke; the control readings from the chip smoke, which asserts that the
    comparison rejects them):
      feat 2**-10: sound 1.5e-4 to 2.0e-4, control 5.3e-3;
      alpha 2**-8: sound up to 1.2e-3 (one output summed over 256 flipped
        or unflipped inputs), control 1.9e-2;
      grad 2**-5: sound up to 7.1e-3 (the cotangent is rounded to bf16 at
        every layer and cancels in the sums that follow, and a
        pre-activation on the other side of zero changes its leaky slope
        from 1 to 0.01), control up to 8.9e-2 (the largest over the
        gradients, as the check takes the largest)."""
    if output not in BF16_LIMITS:
        raise ValueError(f"no tolerance for output {output!r}")
    if compute_dtype == "float32":
        return 2.0 ** -16
    return BF16_LIMITS[output]


# ------------------------------------------------------------------ kernels

def _lib():
    from hybridneuralrendering_tpu_torch.ops.build import load_library
    lib = load_library("shading_chain", KERNEL_LIBS["shading_chain"])
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.chain_fwd_launch.argtypes = [P, I] + [P] * 5 + [LL] + [P] * 3
        lib.chain_bwd_launch.argtypes = [P, I] + [P] * 7 + [LL] + [P] * 7
        lib.chain_dw_launch.argtypes = [P, I, P, P, P, LL, P, I, I, P, P,
                                        P]
        for f in ("chain_fwd_launch", "chain_bwd_launch", "chain_dw_launch"):
            getattr(lib, f).restype = I
        lib._typed = True
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _meta(layout: ChainLayout):
    return (ctypes.c_int * len(layout.meta))(*layout.meta)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_inputs(dt: torch.dtype, *tensors: torch.Tensor) -> None:
    """Devices, types and contiguity; the C functions refuse a chain their
    tiles do not take (a layer over 256 columns, in bf16 a layer input over
    288, shared memory over the card's), and _check raises that."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the chain kernels run on cuda, not {dev}")
    for x in tensors:
        if x.device != dev or x.dtype not in (torch.float32, dt) \
                or not x.is_contiguous():
            raise ValueError("chain kernel inputs must be contiguous, on one "
                             "device, float32 (weights in the compute type)")


# launches of each kernel, counted by its wrapper after a successful launch
LAUNCHES = {"shading_chain_fwd": 0, "shading_chain_bwd": 0,
            "shading_chain_dw": 0}


def chain_forward(layout: ChainLayout, w: torch.Tensor, b: torch.Tensor,
                  emb: torch.Tensor, dists: torch.Tensor,
                  extra: torch.Tensor):
    """chain_fwd on the card: (feat [N, F], alpha_raw [N, H]) f32, from the
    packed weights (w in the compute type, b f32) of `layout`."""
    _check_inputs(w.dtype, emb, dists, extra, w, b)
    n = emb.shape[0]
    feat = torch.empty((n, layout.layers[layout.na + layout.nb - 1].nout),
                       device=emb.device)
    alpha = torch.empty((n, layout.layers[-1].nout), device=emb.device)
    wk = _kernel_weights(layout, w)
    with torch.cuda.device(emb.device):
        err = _lib().chain_fwd_launch(
            _meta(layout), int(w.dtype == torch.bfloat16), emb.data_ptr(),
            dists.data_ptr(), extra.data_ptr(), wk.data_ptr(), b.data_ptr(),
            n, feat.data_ptr(), alpha.data_ptr(), _stream(emb))
    _check(err, "chain_fwd")
    LAUNCHES["shading_chain_fwd"] += 1
    return feat, alpha


def chain_backward(layout: ChainLayout, w, b, emb, dists, extra, dfeat,
                   dalpha):
    """chain_bwd on the card: (d_emb, d_dists, d_extra, A scratch, G
    scratch, db partials per TILE rows) for rows padded to a multiple of
    TILE."""
    _check_inputs(w.dtype, emb, dists, extra, dfeat, dalpha, w, b)
    n = emb.shape[0]
    npad = _rup(n, TILE)
    dev = emb.device
    ascr = torch.empty((npad, layout.atot), dtype=w.dtype, device=dev)
    gscr = torch.empty((npad, layout.gtot), dtype=w.dtype, device=dev)
    dbpart = torch.empty((npad // TILE, layout.btot), device=dev)
    d_emb = torch.empty_like(emb)
    d_dists = torch.empty_like(dists)
    d_extra = torch.empty_like(extra)
    wk = _kernel_weights(layout, w)
    with torch.cuda.device(dev):
        err = _lib().chain_bwd_launch(
            _meta(layout), int(w.dtype == torch.bfloat16), emb.data_ptr(),
            dists.data_ptr(), extra.data_ptr(), dfeat.data_ptr(),
            dalpha.data_ptr(), wk.data_ptr(), b.data_ptr(), n,
            ascr.data_ptr(), gscr.data_ptr(), dbpart.data_ptr(),
            d_emb.data_ptr(), d_dists.data_ptr(), d_extra.data_ptr(),
            _stream(emb))
    _check(err, "chain_bwd")
    LAUNCHES["shading_chain_bwd"] += 1
    return d_emb, d_dists, d_extra, ascr, gscr, dbpart


def chain_dw(layout: ChainLayout, ascr: torch.Tensor, gscr: torch.Tensor,
             dbpart: torch.Tensor) -> torch.Tensor:
    """chain_dw on the card: the packed f32 gradient [wtot + btot] (every
    dW = A^T G and db, in unpack_chain's layout) of the scratch A [npad,
    atot], G [npad, gtot] and the db partials [npad / TILE, btot], summed
    per row split of dw_plan (bf16) or per CHUNK_ROWS rows (float32), then
    over the splits in order."""
    _check_inputs(ascr.dtype, ascr, gscr, dbpart)
    npad = ascr.shape[0]
    if (ascr.dtype not in COMPUTE_DTYPES.values()
            or gscr.dtype != ascr.dtype or dbpart.dtype != torch.float32
            or npad % TILE or ascr.shape != (npad, layout.atot)
            or gscr.shape != (npad, layout.gtot)
            or dbpart.shape != (npad // TILE, layout.btot)):
        raise ValueError("chain_dw: scratch A [npad, atot] and G [npad, "
                         "gtot] of the compute type, db partials [npad / 64, "
                         "btot] float32")
    if ascr.dtype == torch.bfloat16:
        plan = dw_plan(layout, npad)
        parts = plan[1]
    else:
        plan, parts = (), -(-npad // CHUNK_ROWS)
    partial = torch.empty((parts, layout.wtot + layout.btot),
                          device=ascr.device)
    grad = torch.empty(layout.wtot + layout.btot, device=ascr.device)
    with torch.cuda.device(ascr.device):
        err = _lib().chain_dw_launch(
            _meta(layout), int(ascr.dtype == torch.bfloat16),
            ascr.data_ptr(), gscr.data_ptr(), dbpart.data_ptr(), npad,
            (ctypes.c_int * len(plan))(*plan), len(plan), parts,
            partial.data_ptr(), grad.data_ptr(), _stream(ascr))
    _check(err, "chain_dw")
    LAUNCHES["shading_chain_dw"] += 1
    return grad


def backward_on_card(layout: ChainLayout, w, b, emb, dists, extra, dfeat,
                     dalpha):
    """The backward kernels: (d_emb, d_dists, d_extra, the packed f32
    gradient [wtot + btot] in unpack_chain's layout)."""
    d_emb, d_dists, d_extra, ascr, gscr, dbpart = chain_backward(
        layout, w, b, emb, dists, extra, dfeat, dalpha)
    return d_emb, d_dists, d_extra, chain_dw(layout, ascr, gscr, dbpart)


def pack_for(params: Dict, cfg: AggregatorConfig, de: int, dd: int,
             ce: int) -> Tuple[ChainLayout, torch.Tensor, torch.Tensor]:
    """(layout, w, b) of `params` packed for the card's kernels in
    chain_dtype(cfg), for raw inputs of widths de, dd and ce: what
    fused_feat_alpha takes as `packed`, so that the chunks of one step
    (and remat's recomputes) share one pack."""
    layout = chain_layout(params, cfg, de, dd, ce)
    with torch.no_grad():
        w, b = pack_chain(params, layout,
                          COMPUTE_DTYPES[chain_dtype(cfg)])
    return layout, w, b


class FusedFeatAlpha(torch.autograd.Function):
    """(feat, alpha_raw) of the chain, differentiable in its inputs and in
    every weight and bias.  Saves only the raw inputs and the weights (on
    the card as `packed`, pack_for's (layout, w, b) of the same params); the
    backward recomputes the chain, so no pre-activation is kept: what JAX's
    fused_leaky_vjp (mlp._linear_leaky) buys, a smaller saved set, the
    fused chain has whether the knob is on or off.  CUDA tensors launch the
    kernels (or raise); CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, params_like, cfg, packed, emb, dists, extra, *leaves):
        params = nest_like(params_like, [
            {"w": leaves[2 * i], "b": leaves[2 * i + 1]}
            for i in range(len(leaves) // 2)])
        ctx.params_like, ctx.cfg = params_like, cfg
        if emb.device.type == "cpu":
            ctx.layout = None
            ctx.save_for_backward(emb, dists, extra, *leaves)
            return chain_plain(emb, dists, extra, params, cfg,
                               chain_dtype(cfg))
        ctx.layout, w, b = packed
        ctx.save_for_backward(emb, dists, extra, w, b)
        return chain_forward(ctx.layout, w, b, emb, dists, extra)

    @staticmethod
    def backward(ctx, dfeat, dalpha):
        emb, dists, extra, *rest = ctx.saved_tensors
        cfg, layout = ctx.cfg, ctx.layout
        with record_function("chain.bwd"):
            if layout is None:
                params = nest_like(ctx.params_like, [
                    {"w": rest[2 * i], "b": rest[2 * i + 1]}
                    for i in range(len(rest) // 2)])
                d_emb, d_dists, d_extra, g = chain_backward_plain(
                    emb, dists, extra, params, cfg, chain_dtype(cfg),
                    dfeat, dalpha)
                layers = _layer_list(g)
            else:
                d_emb, d_dists, d_extra, packed = backward_on_card(
                    layout, *rest, emb, dists, extra, dfeat.contiguous(),
                    dalpha.contiguous())
                layers = unpack_chain(packed, layout)
        flat = [x for layer in layers for x in (layer["w"], layer["b"])]
        return (None, None, None, d_emb, d_dists, d_extra, *flat)


def fused_feat_alpha(params: Dict, cfg: AggregatorConfig, emb: torch.Tensor,
                     dists: torch.Tensor, extra: torch.Tensor,
                     packed: Optional[Tuple] = None):
    """(feat [N, F] f32, alpha_raw [N, H] f32) of the chain `params`
    ({"block1", ["block2"], "block3", "alpha"}) on emb [N, de], dists
    [N, dd] (encoded inside with abs(cfg.dist_xyz_freq) bands, raw when 0)
    and extra [N, ce] (block3's concat tail; ce may be 0), computed in
    chain_dtype(cfg), the alpha head in float32 where alpha_head_is_f32 says
    so.  On the card `packed` (pack_for of the same params) lets several
    calls share one pack; without it the weights are packed here."""
    if packed is None and emb.is_cuda:
        packed = pack_for(params, cfg, emb.shape[1], dists.shape[1],
                          extra.shape[1])
    leaves = [x for layer in _layer_list(params)
              for x in (layer["w"], layer["b"])]
    shape_only = nest_like(params, [None] * (len(leaves) // 2))
    feat, alpha = FusedFeatAlpha.apply(
        shape_only, cfg, packed, emb.float().contiguous(),
        dists.float().contiguous(), extra.float().contiguous(), *leaves)
    if alpha_head_is_f32(params, cfg):
        # the kernels' bf16-operand alpha is dropped (its cotangent is
        # zero, so the kernels' head gradient is too) for JAX's f32 head
        alpha = alpha_head_f32(feat, params["alpha"][0])
    return feat, alpha
