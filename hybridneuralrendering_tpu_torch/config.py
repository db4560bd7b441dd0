"""Configuration of the port: the knobs the render and the training step
read.

A copy of the dataclasses of `hybridneuralrendering_tpu/config.py` that the
render and training paths need (querier, points, aggregator, render, blur,
sampling, loss, optim), with the same fields and defaults, so that a preset
here equals the JAX preset of the same name field by field
(tests/test_torch_port_config.py checks it).  The probe (grow/prune) and
parallel sub-configs come with the slices that use them.  PRESETS carries
the JAX package's names; the presets whose knobs the port does not run yet
(the learnable blur kernel, the NeRF-synthetic workloads) raise
NotImplementedError naming the ROADMAP item that ports them.

`serve_config()` is the serving workload and `train_config()` the training
workload: `scannet_full` at the shapes of the JAX package's benchmark scene
(600k synthetic points in a +-3.2 m box, 480x640 images).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class QuerierConfig:
    """Voxel-grid ray -> neighbour-point querier (static capacities)."""

    vsize: Tuple[float, float, float] = (0.008, 0.008, 0.008)
    vscale: Tuple[int, int, int] = (2, 2, 2)
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    query_size: Tuple[int, int, int] = (3, 3, 3)
    z_depth_dim: int = 400            # candidate samples per ray
    SR: int = 24                      # shading points kept per ray
    K: int = 8                        # neighbours per shading point
    P: int = 26                       # points stored per voxel
    max_o: int = 610000               # occupied-voxel capacity
    ranges: Tuple[float, float, float, float, float, float] = (
        -10.0, -10.0, -10.0, 10.0, 10.0, 10.0)
    grid_capacity: int = 48_000_000   # dense linear voxel table size
    radius_limit_scale: float = 4.0
    sample_jitter: float = 0.3
    sample_mode: str = "linear"       # 'linear' | 'disparity'
    # one packed bucket per kernel_size-dilated voxel (the K-NN fast path)
    supervoxel: bool = True
    Ps: int = 64                      # points per supervoxel bucket
    max_nodes: int = 2_500_000        # supervoxel-node capacity

    @property
    def query_vsize(self) -> Tuple[float, float, float]:
        return tuple(v * s for v, s in zip(self.vsize, self.vscale))

    @property
    def radius_limit(self) -> float:
        return self.radius_limit_scale * max(self.vsize[0], self.vsize[1])


@dataclass(frozen=True)
class PointsConfig:
    """Neural point cloud layout."""

    num_points: int = 800_000
    feature_dim: int = 32
    color_mode: str = "1"
    dir_mode: str = "1"
    conf_mode: str = "1"
    xyz_grad: bool = False
    feat_grad: bool = True
    conf_grad: bool = True
    color_grad: bool = True
    dir_grad: bool = True
    feature_init_method: str = "rand"


@dataclass(frozen=True)
class AggregatorConfig:
    """The viewmlp shading network + hybrid image-feature fusion.

    The port reads the shading, fusion and training knobs: drop, the
    unique-row gather (dedup_gather, dedup_uncached, renderer.render) and
    the cached maps' reading (staged_materialize, fusion.image_fusion).
    The knobs of unported variants (remat, chunks, fused VJP, learnable
    blur) are carried so that presets compare field by field, and raise
    where they are read (aggregator._check_supported)."""

    which_agg_model: str = "viewmlp"
    agg_distance_kernel: str = "linear"
    agg_dist_pers: int = 20
    agg_intrp_order: int = 2
    agg_weight_norm: bool = True
    agg_axis_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    apply_pnt_mask: bool = True
    act_type: str = "leaky_relu"
    act_super: bool = True

    point_features_dim: int = 32
    shading_feature_num: int = 256
    shading_feature_mlp_layer1: int = 2
    shading_feature_mlp_layer2: int = 0
    shading_feature_mlp_layer3: int = 2
    shading_alpha_mlp_layer: int = 1
    shading_color_mlp_layer: int = 4
    shading_color_channel_num: int = 3

    num_pos_freqs: int = 10
    num_viewdir_freqs: int = 4
    num_feat_freqs: int = 3
    dist_xyz_freq: int = 5
    dist_xyz_deno: float = 0.0

    agg_feat_xyz_mode: str = "None"
    agg_alpha_xyz_mode: str = "None"
    agg_color_xyz_mode: str = "None"
    point_color_mode: str = "1"
    point_dir_mode: str = "1"
    # per-matmul compute dtype; 'float32' runs full precision
    compute_dtype: str = "float32"
    # dtype of the whole image-pyramid chain (convs, maps, upsampling, table)
    pyramid_dtype: str = "bfloat16"
    # dtype of the per-neighbour shading chain; the K-sum stays float32
    shading_dtype: str = "bfloat16"
    remat_chain: bool = False
    chain_chunks: int = 1
    fused_leaky_vjp: bool = False
    dedup_gather: int = 98_304
    dedup_uncached: bool = False

    use_nearest: int = 4
    select_high_quality: bool = False
    dynamic_nearest: bool = False
    dynamic_nearest_pool: int = 8
    staged_materialize: bool = True
    feature_guidance: bool = True
    use_delta_view: bool = True
    downweight_blurry_feats: bool = False
    tradition_attention: bool = False
    use_gumbel_softmax: bool = False
    frame_level_attention: bool = False
    mixup_mode: str = "partial"
    learn_residuals: bool = True
    dynamic_weight: bool = False
    separate_color_decoder: bool = False
    large_color_final_block: bool = False
    add_idx: bool = False
    disable_viewdirs: bool = False
    disable_color_feature: bool = False

    drop_ratio: float = 0.5
    random_position: int = 1
    ray_points: bool = True
    drop_patch: bool = True

    learnable_blur_kernel: bool = False
    learnable_blur_kernel_size: int = 9
    learnable_blur_kernel_mode: int = 4
    learnable_blur_kernel_conv: bool = False
    learnable_blur_kernel_norm: int = 0
    learnable_blur_patch_size: int = 8
    boundary_mode: int = 0

    sparse_loss_weight: float = 0.0

    @property
    def aux_feature_channels(self) -> int:
        """RGB + 3 CNN pyramid stages with channel expansion x2: 45."""
        e = 2
        return 3 * (1 + e + e ** 2 + e ** 3)

    @property
    def dist_dim(self) -> int:
        return ((4 if self.agg_dist_pers == 30 else 6)
                if self.agg_dist_pers > 9 else 3)


@dataclass(frozen=True)
class RenderConfig:
    which_ray_generation: str = "near_far_linear"
    which_render_func: str = "radiance"
    which_blend_func: str = "alpha"
    which_tonemap_func: str = "off"
    raydist_mode_unit: bool = True
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    near_plane: float = 0.1
    far_plane: float = 8.0
    bgmodel: str = "no"


@dataclass(frozen=True)
class BlurConfig:
    """Blur simulation: the linear-motion kernel bank that degrades the
    rendered patches before the loss."""

    add_blur_sim: bool = False
    blur_kernel_version: int = 3          # 1 asym, 2 sym, 3 both
    blur_kernel_size: int = 9
    num_move_dirs: int = 8
    move_dists: Tuple[int, ...] = (1, 2, 4)
    learnable: bool = False

    @property
    def num_kernels(self) -> int:
        n_v1 = len(self.move_dists) * self.num_move_dirs
        n_v2 = len(self.move_dists) * (self.num_move_dirs // 2)
        if self.blur_kernel_version == 1:
            return n_v1
        if self.blur_kernel_version == 2:
            return n_v2
        return n_v1 + n_v2


@dataclass(frozen=True)
class SamplingConfig:
    random_sample: str = "dilated"
    random_sample_size: int = 56
    dilation_patch_num: int = 7
    dilation_patch_size: int = 8
    dilation_max: int = 8
    dilation_min: int = 1
    edge_filter: int = 10
    # rays per eval chunk (0 = the training batch size)
    eval_chunk_rays: int = 0

    @property
    def rays_per_batch(self) -> int:
        return self.random_sample_size ** 2

    @property
    def eval_rays(self) -> int:
        return self.eval_chunk_rays or self.rays_per_batch


@dataclass(frozen=True)
class LossConfig:
    """Loss items and weights."""

    color_loss_items: Tuple[str, ...] = (
        "ray_masked_coarse_raycolor", "ray_miss_coarse_raycolor",
        "coarse_raycolor")
    color_loss_weights: Tuple[float, ...] = (1.0, 0.0, 0.0)
    zero_one_loss_items: Tuple[str, ...] = ("conf_coefficient",)
    zero_one_loss_weights: Tuple[float, ...] = (0.0001,)
    zero_epsilon: float = 1e-3
    sparse_loss_weight: float = 0.0
    use_frame_weight: bool = False
    weight_exp: float = 1.0


@dataclass(frozen=True)
class OptimConfig:
    """Two Adams: network parameters at `lr`, point attributes at `plr`,
    both under the `lr_policy` schedule.  The pyramid-cache knobs set the
    burst schedule (train/pyramid_cache.in_burst, burst_begins)."""

    lr: float = 0.0005        # network params
    plr: float = 0.002        # neural-point params
    mvs_lr: float = 0.0005    # MVS nets (feed-forward mode only)
    lr_policy: str = "iter_exponential_decay"
    lr_decay_iters: int = 1_000_000
    lr_decay_exp: float = 0.1
    maximum_step: int = 200_000
    beta1: float = 0.9
    beta2: float = 0.999
    pyramid_cache: bool = True
    pyramid_cycle_steps: int = 400
    pyramid_burst_steps: int = 40


@dataclass(frozen=True)
class Config:
    name: str = "default"
    querier: QuerierConfig = field(default_factory=QuerierConfig)
    points: PointsConfig = field(default_factory=PointsConfig)
    agg: AggregatorConfig = field(default_factory=AggregatorConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    blur: BlurConfig = field(default_factory=BlurConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    image_hw: Tuple[int, int] = (480, 640)
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def scannet_full(scan: str = "scene0241_01") -> Config:
    """ScanNet full pipeline: hybrid + blur-kernel bank + frame weights
    (dev_scripts/w_scannet_etf/scene241_full.sh)."""
    return Config(
        name=f"{scan}_full",
        querier=QuerierConfig(),
        agg=AggregatorConfig(),
        blur=BlurConfig(add_blur_sim=True),
        loss=LossConfig(use_frame_weight=True),
        sampling=SamplingConfig(eval_chunk_rays=16384),
    )


SERVE_NUM_POINTS = 600_000


def serve_config() -> Config:
    """`scannet_full` at the benchmark scene's shapes (the JAX package's
    bench.py:bench_config): the synthetic scene lives in +-3 m, so the grid
    ranges shrink to +-3.2 and the capacities follow; vsize, SR, K and the
    network widths stay canonical."""
    cfg = scannet_full()
    return cfg.replace(
        querier=QuerierConfig(
            ranges=(-3.2, -3.2, -3.2, 3.2, 3.2, 3.2),
            grid_capacity=70_000_000,
            Ps=32, max_nodes=4_000_000),
        points=PointsConfig(num_points=SERVE_NUM_POINTS),
        image_hw=(480, 640),
    )


def train_config() -> Config:
    """The training workload: serve_config(), whose sampling is already the
    JAX preset's training sampling (56x56 dilated rays from 7x7 patches of
    8x8, R = 3,136 per step), with the preset's blur bank, frame weight and
    two Adams.  Equal field by field to the JAX bench.py:bench_config."""
    return serve_config()


def tiny_test() -> Config:
    """Small everything: CPU-testable shapes, float32 chains."""
    return Config(
        name="tiny",
        querier=QuerierConfig(
            vsize=(0.05, 0.05, 0.05), vscale=(2, 2, 2), SR=6, K=4, P=8,
            max_o=4096, z_depth_dim=32, grid_capacity=200_000,
            ranges=(-2.0, -2.0, -2.0, 2.0, 2.0, 2.0),
            Ps=32, max_nodes=60_000),
        points=PointsConfig(num_points=2048, feature_dim=8),
        agg=AggregatorConfig(
            point_features_dim=8, shading_feature_num=128, use_nearest=2,
            num_feat_freqs=2, dist_xyz_freq=2, drop_ratio=0.5,
            pyramid_dtype="float32", shading_dtype="float32"),
        render=RenderConfig(near_plane=0.1, far_plane=4.0),
        sampling=SamplingConfig(
            random_sample="dilated", random_sample_size=8,
            dilation_patch_num=2, dilation_patch_size=4, edge_filter=0),
        blur=BlurConfig(add_blur_sim=True, blur_kernel_size=5,
                        move_dists=(1, 2)),
        image_hw=(48, 64),
    )


def scannet_hybrid(scan: str = "scene0241_01") -> Config:
    """Hybrid rendering, no blur sim / frame weights (scene241_hybrid.sh)."""
    return Config(
        name=f"{scan}_hybrid",
        blur=BlurConfig(add_blur_sim=False),
        loss=LossConfig(use_frame_weight=False),
        sampling=SamplingConfig(eval_chunk_rays=16384),
    )


def scannet_scene101(scan: str = "scene0101_04") -> Config:
    """scene0101_04 full pipeline (scene101_full.sh): scene241_full with the
    larger point budget (max_o=2,000,000)."""
    base = scannet_full(scan)
    return base.replace(
        querier=dataclasses.replace(base.querier, max_o=2_000_000,
                                    Ps=32, max_nodes=6_000_000),
        points=PointsConfig(num_points=2_000_000),
    )


def scannet_livingroom(scan: str = "livingroom") -> Config:
    """livingroom_full.sh: scene241 settings with dilation_max=6 and the
    symmetric-only blur-kernel bank (version 2)."""
    base = scannet_full(scan)
    return base.replace(
        sampling=dataclasses.replace(base.sampling, dilation_max=6),
        blur=BlurConfig(add_blur_sim=True, blur_kernel_version=2),
    )


def scannet_vangoroom(scan: str = "vangoroom") -> Config:
    """vangoroom_full.sh: the settings of livingroom_full.sh."""
    return scannet_livingroom(scan)


def fixture_room(scan: str = "roomsim") -> Config:
    """scannet_full fitted to the analytic room scene of
    tools/make_fixture_scene.py (the trained fixture checkpoint's config):
    canonical vsize, SR, K and widths; the scene's ranges, capacities and
    240x320 frames."""
    base = scannet_full(scan)
    return base.replace(
        name=f"{scan}_full",
        querier=dataclasses.replace(
            base.querier, ranges=(-2.0, -1.5, -0.5, 2.0, 1.5, 3.6),
            grid_capacity=14_000_000, max_o=400_000,
            Ps=32, max_nodes=2_500_000),
        points=PointsConfig(num_points=400_000),
        render=RenderConfig(near_plane=0.1, far_plane=4.5),
        image_hw=(240, 320),
    )


def _unported(name: str, item: str):
    def preset(*args, **kw) -> Config:
        raise NotImplementedError(
            f"preset {name} is not ported yet (ROADMAP Queue 1 {item})")
    preset.__name__ = name
    return preset


LEARNABLE_BLUR_ITEM = "item 8, the learnable blur kernel"
NERF_ITEM = "items 8 and 11, remat and chunked chains for the NeRF workload"


def apply_blur_overrides(cfg: Config, blur_mode: str = "preset",
                         frame_weight: int = -1) -> Config:
    """The CLI's blur overrides (JAX config.apply_blur_overrides):
    blur_mode 'preset' keeps the preset's setting, 'off' and 'bank' force
    that simulation; frame_weight -1 keeps the preset's, 0 off, 1 on.
    'learnable' raises NotImplementedError: the learnable blur kernel is
    not ported."""
    if blur_mode == "off":
        cfg = cfg.replace(
            blur=dataclasses.replace(cfg.blur, add_blur_sim=False,
                                     learnable=False),
            agg=dataclasses.replace(cfg.agg, learnable_blur_kernel=False))
    elif blur_mode == "bank":
        cfg = cfg.replace(
            blur=dataclasses.replace(cfg.blur, add_blur_sim=True,
                                     learnable=False),
            agg=dataclasses.replace(cfg.agg, learnable_blur_kernel=False))
    elif blur_mode == "learnable":
        raise NotImplementedError(
            f"blur mode learnable is not ported yet (ROADMAP Queue 1 "
            f"{LEARNABLE_BLUR_ITEM})")
    elif blur_mode != "preset":
        raise KeyError(f"unknown blur_mode {blur_mode}")
    if frame_weight >= 0:
        cfg = cfg.replace(loss=dataclasses.replace(
            cfg.loss, use_frame_weight=bool(frame_weight)))
    return cfg


PRESETS = {
    "scannet_full": scannet_full,
    "scannet_hybrid": scannet_hybrid,
    "scannet_learnable": _unported("scannet_learnable", LEARNABLE_BLUR_ITEM),
    "scannet_scene101": scannet_scene101,
    "scannet_livingroom": scannet_livingroom,
    "scannet_vangoroom": scannet_vangoroom,
    "nerf_synth_points": _unported("nerf_synth_points", NERF_ITEM),
    "nerf_synth_hybrid": _unported("nerf_synth_hybrid", NERF_ITEM),
    "fixture_nerf_points": _unported("fixture_nerf_points", NERF_ITEM),
    "fixture_nerf_hybrid": _unported("fixture_nerf_hybrid", NERF_ITEM),
    "fixture_room": fixture_room,
    "tiny": tiny_test,
    "serve": serve_config,
    "train": train_config,
}
