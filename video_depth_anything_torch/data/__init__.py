"""Training datasets (the JAX package's ``data/``): scene loaders, the clip
sampler (``clips.py``) and augmentation (``augment.py``).  ``get_dataset``
knows the JAX package's eight names; of the loaders only PointOdyssey is
ported so far."""

from video_depth_anything_torch.data.base import SceneDepthDataset  # noqa: F401

DATASETS = ("kitti", "vkitti", "sintel", "tartanair", "pointodyssey", "dynamicreplica",
            "sceneflow", "irs")


def get_dataset(name: str, root: str, **kwargs) -> SceneDepthDataset:
    name = name.lower()
    if name == "pointodyssey":
        from video_depth_anything_torch.data.pointodyssey import PointOdyssey

        return PointOdyssey(root, **kwargs)
    if name in DATASETS:
        raise NotImplementedError(
            f"the {name!r} loader is not yet ported (ROADMAP Queue 1 item 10); pointodyssey is")
    raise ValueError(f"unknown dataset {name!r}")
