"""The port's data layer, PNG codec, metrics and visualizer against the JAX
package (and PIL / imageio for the PNG files).

Tolerances: every array of the data layer (pixel samplers, nearest views,
point init, ScannetScene's lists, intrinsics, weights, images, depth maps
and batches) is equal, dtypes included: both packages run the same numpy.
PNG pixels are equal.  Metrics: the port computes them in float64 on
tensors, JAX in float64 numpy, in the same order of sums, so they agree to
1e-12 relative.
"""

import dataclasses
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.data import nearest_views as jnv
from hybridneuralrendering_tpu.data import point_init as jpi
from hybridneuralrendering_tpu.data import sampling as jsampling
from hybridneuralrendering_tpu.data import scannet as jscannet
from hybridneuralrendering_tpu.utils import metrics as JM
from hybridneuralrendering_tpu.utils import visualizer as JV
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.data import nearest_views as tnv
from hybridneuralrendering_tpu_torch.data import point_init as tpi
from hybridneuralrendering_tpu_torch.data import sampling as tsampling
from hybridneuralrendering_tpu_torch.data import scannet as tscannet
from hybridneuralrendering_tpu_torch.io import png
from hybridneuralrendering_tpu_torch.utils import metrics as TM
from hybridneuralrendering_tpu_torch.utils import visualizer as TV
from torch_port_common import write_fake_scannet

FIXTURE_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".fixture")
METRIC_RTOL = 1e-12


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ------------------------------------------------------------------ io/png

PNG_CASES = [((37, 53), np.uint8, "L"), ((37, 53, 3), np.uint8, "RGB"),
             ((37, 53, 4), np.uint8, "RGBA"), ((37, 53), np.uint16, None),
             ((1, 1, 3), np.uint8, "RGB"), ((480, 640, 3), np.uint8, "RGB")]


def _pixels(shape, dtype, seed=0):
    """Noise on a smooth ramp, so that writers pick every filter type."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    if len(shape) == 3:
        ramp = ramp[..., None] * np.arange(1, shape[2] + 1)
    noise = rng.integers(0, 8, shape)
    return ((ramp + noise) % (top + 1)).astype(dtype)


@pytest.mark.parametrize("shape,dtype,mode", PNG_CASES)
def test_png_round_trip(tmp_path, shape, dtype, mode):
    a = _pixels(shape, dtype)
    p = str(tmp_path / "a.png")
    png.write(p, a)
    assert_same(png.read(p), a)


@pytest.mark.parametrize("shape,dtype,mode", PNG_CASES)
def test_png_reads_what_pil_and_imageio_write(tmp_path, shape, dtype, mode):
    a = _pixels(shape, dtype, seed=1)
    p = str(tmp_path / "a.png")
    imageio.imwrite(p, a)
    assert_same(png.read(p), a, "imageio")
    if mode is not None:
        Image.fromarray(a, mode).save(p)
        assert_same(png.read(p), a, "PIL")


@pytest.mark.parametrize("shape,dtype,mode", PNG_CASES)
def test_pil_and_imageio_read_what_png_writes(tmp_path, shape, dtype, mode):
    a = _pixels(shape, dtype, seed=2)
    p = str(tmp_path / "a.png")
    png.write(p, a)
    assert_same(imageio.imread(p), a, "imageio")
    if mode is not None:
        assert_same(np.asarray(Image.open(p)), a, "PIL")


def _filtered_png(a, ftypes):
    """PNG bytes of a uint8 image whose scanline y takes filter
    ftypes[y % len(ftypes)], by a plain per-byte reference filter."""
    import struct
    import zlib
    h = a.shape[0]
    bpp = 1 if a.ndim == 2 else a.shape[2]
    rows = a.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        f = ftypes[y % len(ftypes)]
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        line = []
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            up, ul = prev[i], (prev[i - bpp] if i >= bpp else 0)
            if f == 0:
                pred = 0
            elif f == 1:
                pred = left
            elif f == 2:
                pred = up
            elif f == 3:
                pred = (left + up) // 2
            else:
                p_ = left + up - ul
                pa, pb, pc = abs(p_ - left), abs(p_ - up), abs(p_ - ul)
                pred = left if pa <= pb and pa <= pc else (
                    up if pb <= pc else ul)
            line.append((cur[i] - pred) % 256)
        out.append(bytes([f] + line))
    ctype = {1: 0, 3: 2, 4: 6}[bpp]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    ihdr = struct.pack(">IIBBBBB", a.shape[1], h, 8, ctype, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_every_filter(ftype, channels):
    shape = (9, 13) if channels == 1 else (9, 13, channels)
    a = _pixels(shape, np.uint8, seed=ftype)
    data = _filtered_png(a, [ftype, 4, 3, 1, 2, 0])
    assert_same(png.decode(data), a)
    import io
    assert_same(np.asarray(Image.open(io.BytesIO(data))), a, "PIL")


def test_png_refuses_what_it_does_not_read(tmp_path):
    p = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(p)
    with pytest.raises(ValueError, match="colour type"):
        png.read(p)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(20), "x.gif")
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 3), np.uint16))


# ------------------------------------------------------ sampling and views

SAMPLERS = ["patch", "random", "random2", "dilated"]


@pytest.mark.parametrize("mode", SAMPLERS)
def test_sample_pixels_equal(mode):
    jc = JC.scannet_full().sampling
    tc = TC.scannet_full().sampling
    jc = dataclasses.replace(jc, random_sample=mode)
    tc = dataclasses.replace(tc, random_sample=mode)
    for seed in range(3):
        assert_same(tsampling.sample_pixels(tc, 480, 640,
                                            np.random.default_rng(seed)),
                    jsampling.sample_pixels(jc, 480, 640,
                                            np.random.default_rng(seed)))


@pytest.mark.parametrize("hw,margin,chunk", [((48, 64), 0, 1024),
                                             ((480, 640), 0, 16384),
                                             ((30, 40), 3, 100)])
def test_full_grid_and_chunks_equal(hw, margin, chunk):
    tg = tsampling.full_image_grid(*hw, margin=margin)
    assert_same(tg, jsampling.full_image_grid(*hw, margin=margin))
    tch, tn = tsampling.chunk_pixels(tg, chunk)
    jch, jn = jsampling.chunk_pixels(tg, chunk)
    assert tn == jn
    assert_same(tch, jch)


@pytest.mark.parametrize("hq,excl", [(False, True), (False, False),
                                     (True, True), (True, False)])
def test_nearest_by_frame_id_equal(hq, excl):
    rng = np.random.default_rng(0)
    train = sorted(rng.choice(200, 40, replace=False).tolist())
    w = rng.uniform(0.2, 1.0, len(train))
    for vid in [train[0], train[7], 3, 199, 100]:
        for num in (1, 4, 8):
            assert_same(
                tnv.nearest_by_frame_id(train, vid, num, w, hq, excl),
                jnv.nearest_by_frame_id(train, vid, num, w, hq, excl))


@pytest.mark.parametrize("excl", [False, True])
def test_nearest_by_dir_then_pos_equal(excl):
    rng = np.random.default_rng(1)
    n = 60
    poses = rng.normal(size=(n, 3))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ids = np.arange(n) * 5
    for i in (0, 11, 59):
        args = (poses[i], dirs[i], int(ids[i]), poses, dirs, ids, 4)
        assert_same(tnv.nearest_by_dir_then_pos(*args, exclude_self=excl),
                    jnv.nearest_by_dir_then_pos(*args, exclude_self=excl))


# -------------------------------------------------------------- point init

def test_unproject_and_downsample_equal():
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.1, 9.0, (30, 40)).astype(np.float32)
    K = np.array([[30.0, 0, 20], [0, 30.0, 15], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = (0.3, -0.2, 1.0)
    pts = tpi.unproject_depth(depth, K, c2w)
    assert_same(pts, jpi.unproject_depth(depth, K, c2w))
    for res in (4, 16):
        assert_same(tpi.voxel_downsample_centroid(pts, res),
                    jpi.voxel_downsample_centroid(pts, res))
        tp, ti = tpi.voxel_downsample_closest(pts, res)
        jp, ji = jpi.voxel_downsample_closest(pts, res)
        assert_same(tp, jp)
        assert_same(ti, ji)
    ranges = (-1.0, -1.0, 0.5, 1.0, 1.0, 5.0)
    assert_same(tpi.clip_to_ranges(pts, ranges),
                jpi.clip_to_ranges(pts, ranges))


def _write_ply(path, xyz, binary):
    extra = np.arange(len(xyz), dtype=np.uint8)
    header = ("ply\nformat {} 1.0\nelement vertex {}\nproperty float x\n"
              "property float y\nproperty float z\nproperty uchar red\n"
              "element face 0\nproperty list uchar int vertex_indices\n"
              "end_header\n").format(
                  "binary_little_endian" if binary else "ascii", len(xyz))
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            rec = np.zeros(len(xyz), dtype=[("x", "<f4"), ("y", "<f4"),
                                            ("z", "<f4"), ("red", "u1")])
            rec["x"], rec["y"], rec["z"] = xyz.T
            rec["red"] = extra
            f.write(rec.tobytes())
        else:
            for p, r in zip(xyz, extra):
                f.write(f"{p[0]} {p[1]} {p[2]} {r}\n".encode("ascii"))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("ranges", [None, (-0.5, -0.5, -0.5, 0.5, 0.5, 0.5),
                                    (-100.0, -1, -1, 1, 1, 1)])
def test_load_ply_points_equal(tmp_path, binary, ranges):
    xyz = np.random.default_rng(3).uniform(-1, 1, (50, 3)).astype(np.float32)
    p = str(tmp_path / "pcd.ply")
    _write_ply(p, xyz, binary)
    got = tpi.load_ply_points(p, ranges)
    assert_same(got, jpi.load_ply_points(p, ranges))
    if ranges is None:
        np.testing.assert_allclose(got, xyz, rtol=1e-6)


# ---------------------------------------------------------- ScannetScene

SCENES = {
    # (scene writer kwargs, config overrides on agg / loss)
    "jpg": (dict(ext="jpg"), {}, {}),
    "png": (dict(ext="png"), {}, {}),
    "resized_png": (dict(ext="png", hw=(60, 80)), {}, {}),
    "weights_blur_badpose": (
        dict(ext="jpg", n_frames=16, bad_pose=(7,), blur_list=(5,),
             frame_weights=[0.9, 0.4, 0.7]),
        dict(select_high_quality=True, downweight_blurry_feats=True),
        dict(use_frame_weight=True, weight_exp=2.0)),
    "dynamic_nearest": (dict(ext="png", n_frames=14),
                        dict(dynamic_nearest=True, dynamic_nearest_pool=5),
                        dict(use_frame_weight=True)),
    "short_scene": (dict(ext="png", n_frames=6), dict(use_nearest=4), {}),
}


def _configs(agg, loss):
    jc, tc = JC.tiny_test(), TC.tiny_test()
    return (jc.replace(agg=dataclasses.replace(jc.agg, **agg),
                       loss=dataclasses.replace(jc.loss, **loss)),
            tc.replace(agg=dataclasses.replace(tc.agg, **agg),
                       loss=dataclasses.replace(tc.loss, **loss)))


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request, tmp_path_factory):
    kw, agg, loss = SCENES[request.param]
    root, scan = write_fake_scannet(tmp_path_factory.mktemp("scans"), **kw)
    jc, tc = _configs(agg, loss)
    return root, scan, jc, tc


def _compare_scenes(js, ts):
    for k in ("all_id_list", "train_id_list", "test_id_list", "id_list"):
        assert getattr(ts, k) == getattr(js, k), k
    for k in ("intrinsic", "depth_intrinsic", "train_weight_list"):
        assert_same(getattr(ts, k), getattr(js, k), k)
    assert (ts.height, ts.width) == (js.height, js.width)
    assert len(ts) == len(js)


def _compare_batches(jb, tb):
    assert sorted(tb) == sorted(jb)
    for k in jb:
        if k == "vid":
            assert tb[k] == jb[k]
        else:
            assert_same(tb[k], jb[k], k)


@pytest.mark.parametrize("split", ["train", "test"])
def test_scannet_scene_equal(scene_pair, split):
    root, scan, jc, tc = scene_pair
    js = jscannet.ScannetScene(root, scan, jc, split)
    ts = tscannet.ScannetScene(root, scan, tc, split)
    _compare_scenes(js, ts)
    for vid in js.all_id_list:
        assert_same(ts.image(vid), js.image(vid), f"image {vid}")
        assert_same(ts.depth(vid), js.depth(vid), f"depth {vid}")
    for idx in range(len(js)):
        try:
            jb = js.get_batch(idx, rng=np.random.default_rng(idx))
        except ValueError as e:
            # both packages set the train split's id_list before the blur
            # list removes frames from train_id_list: with frame weights on,
            # a batch of a removed frame fails the weight lookup in both
            with pytest.raises(ValueError, match=str(e)):
                ts.get_batch(idx, rng=np.random.default_rng(idx))
            continue
        _compare_batches(jb, ts.get_batch(idx, rng=np.random.default_rng(idx)))
    pix = jsampling.full_image_grid(js.height, js.width)[::7, ::5]
    _compare_batches(
        js.get_batch(0, np.random.default_rng(9), pixelcoords=pix),
        ts.get_batch(0, np.random.default_rng(9), pixelcoords=pix))
    assert_same(ts.load_init_depth_points(vox_res=8, frame_stride=2),
                js.load_init_depth_points(vox_res=8, frame_stride=2))


def test_device_batch_drops_host_keys(scene_pair):
    root, scan, jc, tc = scene_pair
    ts = tscannet.ScannetScene(root, scan, tc, "test")
    b = ts.get_batch(0)
    db = tscannet.device_batch(b, "cpu")
    assert set(db) == set(b) - set(tscannet.HOST_KEYS)
    for k, v in db.items():
        assert torch.is_tensor(v) and v.device.type == "cpu"
        assert_same(v.numpy(), b[k], k)


def test_device_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscannet.device_batch({"campos": np.zeros(3, np.float32)})


def test_frame_needing_pil_names_the_frame(tmp_path, monkeypatch):
    root, scan = write_fake_scannet(tmp_path, n_frames=6, ext="png",
                                    hw=(60, 80))
    ts = tscannet.ScannetScene(root, scan, TC.tiny_test(), "test")
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match=r"color/1\.png"):
        ts.image(1)


@pytest.fixture(scope="module")
def roomsim():
    if not os.path.isdir(os.path.join(FIXTURE_ROOT, "roomsim")):
        pytest.skip("the roomsim fixture is not in this checkout")
    return FIXTURE_ROOT, "roomsim"


@pytest.mark.parametrize("split", ["train", "test"])
def test_scannet_scene_equal_on_roomsim(roomsim, split):
    root, scan = roomsim
    jc, tc = JC.fixture_room(), TC.fixture_room()
    js = jscannet.ScannetScene(root, scan, jc, split)
    ts = tscannet.ScannetScene(root, scan, tc, split)
    _compare_scenes(js, ts)
    for idx in (0, len(js) - 1):
        _compare_batches(js.get_batch(idx, rng=np.random.default_rng(5)),
                         ts.get_batch(idx, rng=np.random.default_rng(5)))
    vid = js.id_list[0]
    assert_same(ts.depth(vid), js.depth(vid))


# ------------------------------------------------------------------ metrics

def _image_pairs(seed, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    noisy = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    return [(noisy, gt), (gt, gt), (gt[..., 0], noisy[..., 0]),
            (np.zeros_like(gt), gt)]


@pytest.mark.parametrize("fn", ["psnr", "rmse", "ssim"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal(fn, seed):
    for img, ref in _image_pairs(seed):
        want = getattr(JM, fn)(img, ref)
        got = getattr(TM, fn)(torch.as_tensor(img), torch.as_tensor(ref))
        assert got == pytest.approx(want, rel=METRIC_RTOL, abs=1e-15), fn


def test_ssim_data_range_equal():
    img, ref = _image_pairs(3, (40, 30))[0]
    assert TM.ssim(img, ref, max_val=2.0) == pytest.approx(
        JM.ssim(img, ref, max_val=2.0), rel=METRIC_RTOL)


@pytest.mark.parametrize("with_lpips", [False, True])
def test_report_metrics_equal(with_lpips):
    pairs = _image_pairs(4)[:2] + _image_pairs(5)[:1]
    preds, gts = [p for p, _ in pairs], [g for _, g in pairs]
    want = JM.report_metrics(preds, gts, with_lpips=with_lpips)
    got = TM.report_metrics([torch.as_tensor(p) for p in preds],
                            [torch.as_tensor(g) for g in gts],
                            with_lpips=with_lpips)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), k
    assert TM.lpips(preds[0], gts[0]) == JM.lpips(preds[0], gts[0])


# --------------------------------------------------------------- visualizer

def test_to8b_truncates_as_jax():
    x = np.linspace(-0.2, 1.2, 999, dtype=np.float32).reshape(111, 3, 3)
    assert_same(TV.to8b(torch.as_tensor(x)), JV.to8b(x))
    assert_same(TV.to8b(x), JV.to8b(x))


def test_visualizer_artefacts_equal(tmp_path):
    img = np.random.default_rng(6).uniform(0, 1, (20, 30, 3)).astype(
        np.float32)
    outs = {}
    for label, mod in (("jax", JV), ("port", TV)):
        vis = mod.Visualizer(str(tmp_path / label), "run")
        p = vis.save_image(torch.as_tensor(img) if mod is TV else img, 3,
                           "coarse_raycolor")
        assert os.path.basename(p) == "step-0003-coarse_raycolor.png"
        vis.accumulate_losses({"coarse_raycolor": 0.01, "loss": 0.5})
        vis.accumulate_losses({"coarse_raycolor": 0.03, "loss": 0.7})
        vis.print_losses(7, extra="x")
        vis.log("done")
        with open(vis.log_path) as f:
            log = [line.split("] ", 1)[1] for line in f]
        with open(os.path.join(vis.dir, "scalars.jsonl")) as f:
            outs[label] = (imageio.imread(p), log, f.read())
    assert_same(outs["port"][0], outs["jax"][0])
    assert outs["port"][1:] == outs["jax"][1:]
