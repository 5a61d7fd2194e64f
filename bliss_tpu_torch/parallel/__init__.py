"""Analysis and top-k over a device mesh (counterpart of
``bliss_tpu/parallel``): ``mesh.py`` the sharded stage, ``collectives.py``
its collectives, ``distributed.py`` the ``torch.distributed`` set-up."""

from bliss_tpu_torch.parallel.mesh import (
    Mesh,
    analysis_mesh,
    analyze_sharded,
    analyze_sharded_async,
    shard_batch,
    sharded_distance_topk,
)
from bliss_tpu_torch.parallel.distributed import init_distributed, pod_mesh, process_mesh

__all__ = [
    "Mesh",
    "analysis_mesh",
    "analyze_sharded",
    "analyze_sharded_async",
    "shard_batch",
    "sharded_distance_topk",
    "init_distributed",
    "pod_mesh",
    "process_mesh",
]
