"""Dataset registry.  Only the procedural ``synthetic`` scene loads so far:
the SCARED / Hamlyn / finetune loaders decode images, which waits on a
decoder that needs no cv2 or PIL."""

from ucnerf_torch.data.synthetic import SyntheticDataset

dataset_dict = {"synthetic": SyntheticDataset}


def build_dataset(cfg, split: str):
    """Construct the configured dataset for a split."""
    if cfg.dataset_name not in dataset_dict:
        raise ValueError(
            f"dataset {cfg.dataset_name!r} is not available in ucnerf_torch "
            f"yet (available: {sorted(dataset_dict)})")
    kw = dict(split=split, n_views=cfg.view_num,
              n_depth_rays=cfg.n_depth_rays,
              max_train_samples=cfg.samples_per_scene)
    # 2V images keep >= V train views (every other image is a train view)
    kw["n_images"] = max(12, 2 * cfg.view_num)
    if cfg.img_wh:
        kw["img_wh"] = tuple(cfg.img_wh)
    if cfg.n_scans > 1:
        kw["n_scans"] = cfg.n_scans
    return dataset_dict[cfg.dataset_name](cfg.datadir, **kw)
