"""Host-side data of the PyTorch port (numpy only): the synthetic dataset,
the batching pipeline and the BEV cell sort."""

from lmsu_tpu_torch.data.pipeline import (Batcher, PrefetchLoader, make_loader,
                                          materialize_dataset)
from lmsu_tpu_torch.data.synthetic import (SyntheticMultiModalDataset,
                                           create_synthetic_datasets)


def create_datasets(config, verbose: bool = False):
    """Dataset factory switching on DataConfig.dataset. The port has the
    synthetic dataset; PandaSet and the packed format are not ported yet."""
    if config.dataset == "synthetic":
        return create_synthetic_datasets(config)
    if config.dataset in ("pandaset", "packed"):
        raise NotImplementedError(f"dataset {config.dataset!r} is not ported yet")
    raise ValueError(f"Unknown dataset: {config.dataset}")


__all__ = ["Batcher", "PrefetchLoader", "make_loader", "materialize_dataset",
           "SyntheticMultiModalDataset", "create_synthetic_datasets", "create_datasets"]
