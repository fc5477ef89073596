"""Serving runtime of the PyTorch port: dynamic-batching engine + stdlib
HTTP front-end (counterpart of lmsu_tpu/serving)."""

from lmsu_tpu_torch.serving.engine import EngineOverloaded, ServingEngine
from lmsu_tpu_torch.serving.http import make_server

__all__ = ["ServingEngine", "EngineOverloaded", "make_server"]
