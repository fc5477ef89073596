"""Parallelism over torch.distributed: the (data, model) mesh and its
collectives (mesh.py) and the teacher's partitions: fsdp over the data
axis, tp and sp over the model axis (tp.py)."""

from lmsu_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce_, all_reduce_sum,
                                          broadcast_, broadcast_module_, data_mesh, make_mesh,
                                          model_mesh, process_data_stripes)

__all__ = ["Mesh", "make_mesh", "process_data_stripes", "data_mesh", "model_mesh",
           "all_reduce_", "all_reduce_sum", "all_gather", "broadcast_", "broadcast_module_"]
