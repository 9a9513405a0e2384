"""Data parallelism: device meshes and the multi-process runtime.

Ports `mscnn_tpu/parallel/` (`mesh.py`, `distributed.py`); the 2-D
("data", "space") GSPMD step of `spmd.py` is ROADMAP item 20b.
"""

from mscnn_torch.parallel.mesh import (  # noqa: F401
    Mesh, data_parallel_mesh, local_device_count, make_mesh,
)
