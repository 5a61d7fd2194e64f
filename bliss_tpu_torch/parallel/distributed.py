"""Multi-process set-up (counterpart of ``bliss_tpu/parallel/distributed.py``).

``init_distributed`` joins this process to a ``torch.distributed`` group:
NCCL when the caller's device is CUDA, gloo on the CPU. Nothing on a
machine tells a program of a cluster here, so the caller gives the
coordinator's address (``host:port``, or an ``init_method`` URL such as
``file:///path``), the number of processes and this one's id, or a launcher
sets ``MASTER_ADDR``/``WORLD_SIZE``/``RANK``. ``pod_mesh`` then builds the
('data', 'seq') mesh over the ranks (``process_mesh``: one shard a rank, the
per-shard stage of ``mesh.py`` unchanged over ``ProcessGroup``), or over
this process's devices at world size 1.
"""

from __future__ import annotations

import os

import torch

from bliss_tpu_torch.parallel.collectives import ProcessGroup
from bliss_tpu_torch.parallel.mesh import Mesh, analysis_mesh
from bliss_tpu_torch.utils import get_logger, log_event

logger = get_logger("bliss_tpu_torch.distributed")

_LAUNCHER = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device="cuda",
) -> None:
    """Initialize ``torch.distributed`` (a no-op when it already is). With
    no arguments and no launcher environment, this process stays alone and
    logs "single-process mode", as it does when the group cannot be
    formed."""
    import torch.distributed as dist

    if dist.is_initialized():
        return  # already initialized
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given) and not all(k in os.environ for k in _LAUNCHER):
        log_event(logger, "single-process mode",
                  reason="no coordinator address and no launcher environment")
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init_method = None
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=-1 if num_processes is None else num_processes,
                                rank=-1 if process_id is None else process_id)
        log_event(logger, "distributed initialized", processes=dist.get_world_size(),
                  rank=dist.get_rank(), backend=backend)
    except (ValueError, RuntimeError) as e:
        log_event(logger, "single-process mode", reason=str(e)[:120])


def process_mesh(n_seq: int = 1, device=None) -> Mesh:
    """The ('data', 'seq') mesh of every rank of the default group, one
    shard a rank on ``device`` (default: ``cuda:<rank % device count>``
    under NCCL, the CPU under gloo): rank r holds shard (r // n_seq,
    r % n_seq), and each data row's ranks form its seq ``ProcessGroup``."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if n_seq < 1 or world % n_seq:
        raise ValueError(f"n_seq={n_seq} does not divide the world size {world}")
    if device is None:
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    n_data = world // n_seq
    group = None  # the default group, when one data row spans it
    if n_data > 1:
        # every rank makes every row's group, in the same order
        rows = [dist.new_group(list(range(d * n_seq, (d + 1) * n_seq))) for d in range(n_data)]
        group = rows[rank // n_seq]
    grid = [[device] * n_seq for _ in range(n_data)]
    return Mesh(grid, process=(rank // n_seq, ProcessGroup(device, group)))


def pod_mesh(n_seq: int = 1, devices=None) -> Mesh:
    """('data', 'seq') mesh over every process: across the ranks of an
    initialized group of more than one (``process_mesh``), else over this
    process's ``devices`` (default: every visible CUDA device). Songs shard
    across the data rows, long PCM streams within a row."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        return process_mesh(n_seq, None if devices is None else devices[0])
    return analysis_mesh(None, n_seq, devices)
