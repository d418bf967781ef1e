"""Dataset registry: the JAX package's (``ucnerf_tpu.data``), with the
SCARED and Hamlyn loaders, the finetune split and the procedural
``synthetic`` scene."""

from ucnerf_torch.data.finetune import FinetuneDataset
from ucnerf_torch.data.scared import HamlynDataset, ScaredDataset
from ucnerf_torch.data.synthetic import SyntheticDataset

dataset_dict = {
    "scared": ScaredDataset,
    "hamlyn": HamlynDataset,
    "finetune": FinetuneDataset,
    "synthetic": SyntheticDataset,
}


def build_dataset(cfg, split: str):
    """Construct the configured dataset for a split."""
    if cfg.dataset_name not in dataset_dict:
        raise ValueError(f"unknown dataset {cfg.dataset_name!r} (available: "
                         f"{sorted(dataset_dict)})")
    cls = dataset_dict[cfg.dataset_name]
    kw = dict(split=split, n_views=cfg.view_num,
              n_depth_rays=cfg.n_depth_rays,
              max_train_samples=cfg.samples_per_scene)
    if cfg.dataset_name in ("scared", "hamlyn", "finetune"):
        # --imgScale_train/test: None keeps the dataset's native scale
        scale = cfg.imgScale_train if split == "train" else cfg.imgScale_test
        if scale is not None:
            kw["downsample"] = scale
    if cfg.dataset_name == "finetune" and cfg.finetune:
        kw["finetune_scan"] = cfg.finetune
    if cfg.dataset_name == "synthetic":
        # 2V images keep >= V train views (every other image is a train view)
        kw["n_images"] = max(12, 2 * cfg.view_num)
        if cfg.img_wh:
            kw["img_wh"] = tuple(cfg.img_wh)
        if cfg.n_scans > 1:
            kw["n_scans"] = cfg.n_scans
    return cls(cfg.datadir, **kw)
