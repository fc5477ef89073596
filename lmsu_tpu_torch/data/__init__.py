"""Host-side data of the PyTorch port (numpy only): PandaSet scenes, the
synthetic dataset, packs, the batching pipeline and the BEV cell sort."""

from lmsu_tpu_torch.data.packed import PackedDataset, create_packed_datasets, write_pack
from lmsu_tpu_torch.data.pandaset import (PandaSetDataset, create_pandaset_datasets,
                                          list_scenes, split_scenes)
from lmsu_tpu_torch.data.pipeline import (Batcher, PrefetchLoader, make_loader,
                                          materialize_dataset)
from lmsu_tpu_torch.data.rasterize import DRIVABLE_RAW_IDS, rasterize_bev, remap_semantic
from lmsu_tpu_torch.data.synthetic import (SyntheticMultiModalDataset,
                                           create_synthetic_datasets)


def create_datasets(config, verbose: bool = False):
    """Dataset factory switching on DataConfig.dataset: "pandaset",
    "synthetic" or "packed"."""
    if config.dataset == "pandaset":
        return create_pandaset_datasets(config, verbose=verbose)
    if config.dataset == "synthetic":
        return create_synthetic_datasets(config)
    if config.dataset == "packed":
        return create_packed_datasets(config)
    raise ValueError(f"Unknown dataset: {config.dataset}")


__all__ = [
    "PandaSetDataset", "create_pandaset_datasets", "list_scenes", "split_scenes",
    "Batcher", "PrefetchLoader", "make_loader", "materialize_dataset",
    "rasterize_bev", "remap_semantic", "DRIVABLE_RAW_IDS",
    "SyntheticMultiModalDataset", "create_synthetic_datasets",
    "PackedDataset", "create_packed_datasets", "write_pack",
    "create_datasets",
]
