"""Data parallelism over torch.distributed: the mesh and its collectives
(mesh.py) and the fsdp teacher (tp.py)."""

from lmsu_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce_, all_reduce_sum,
                                          broadcast_, broadcast_module_, make_mesh,
                                          process_data_stripes)

__all__ = ["Mesh", "make_mesh", "process_data_stripes", "all_reduce_", "all_reduce_sum",
           "all_gather", "broadcast_", "broadcast_module_"]
