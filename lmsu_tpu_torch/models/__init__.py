"""Models of the PyTorch port, under the reference's torch module names."""

from lmsu_tpu_torch.models.factory import count_parameters, create_model

__all__ = ["create_model", "count_parameters"]
