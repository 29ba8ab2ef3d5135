"""Scene datasets (the JAX package's ``data/``): the eight scene loaders,
the clip sampler (``clips.py``), augmentation (``augment.py``) and the
dataset visualizations (``visualize.py``).  Every loader is a copy of the
JAX package's numpy loader: the same files give the same arrays."""

from video_depth_anything_torch.data.base import SceneDepthDataset  # noqa: F401

DATASETS = ("kitti", "vkitti", "sintel", "tartanair", "pointodyssey", "dynamicreplica",
            "sceneflow", "irs")


def get_dataset(name: str, root: str, **kwargs) -> SceneDepthDataset:
    """The loader of ``name`` (one of ``DATASETS``) over ``root``, with the
    JAX ``get_dataset``'s keyword arguments."""
    name = name.lower()
    if name == "kitti":
        from video_depth_anything_torch.data.kitti import KITTI

        return KITTI(root, **kwargs)
    if name == "vkitti":
        from video_depth_anything_torch.data.vkitti import VKITTI

        return VKITTI(root, **kwargs)
    if name == "sintel":
        from video_depth_anything_torch.data.sintel import Sintel

        return Sintel(root, **kwargs)
    if name == "tartanair":
        from video_depth_anything_torch.data.tartanair import TartanAir

        return TartanAir(root, **kwargs)
    if name == "pointodyssey":
        from video_depth_anything_torch.data.pointodyssey import PointOdyssey

        return PointOdyssey(root, **kwargs)
    if name == "dynamicreplica":
        from video_depth_anything_torch.data.dynamicreplica import DynamicReplica

        return DynamicReplica(root, **kwargs)
    if name == "sceneflow":
        from video_depth_anything_torch.data.sceneflow import SceneFlow

        return SceneFlow(root, **kwargs)
    if name == "irs":
        from video_depth_anything_torch.data.irs import IRS

        return IRS(root, **kwargs)
    raise ValueError(f"unknown dataset {name!r}")
