"""Data layer (JAX: hybridneuralrendering_tpu/data): the scene loaders,
samplers and camera paths, and the dataset factory."""


def create_dataset(name: str, data_root: str, scan: str, cfg,
                   split: str = "train"):
    """The scene of a dataset family by its JAX name (JAX
    data/__init__.py:create_dataset)."""
    if name in ("scannet", "scannet_ft"):
        from hybridneuralrendering_tpu_torch.data.scannet import ScannetScene
        return ScannetScene(data_root, scan, cfg, split)
    if name in ("nerf_synth", "nerf_synth360", "nerf_synth360_ft"):
        from hybridneuralrendering_tpu_torch.data.nerf_synth import (
            NerfSynthScene)
        return NerfSynthScene(data_root, scan, cfg, split)
    raise KeyError(f"unknown dataset {name!r}")
