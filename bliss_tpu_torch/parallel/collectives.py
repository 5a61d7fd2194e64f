"""Collectives over the shards of one mesh axis (counterpart of the XLA
collectives that ``bliss_tpu/parallel/mesh.py`` calls inside ``shard_map``).

The per-shard stage (``mesh.py``) is written once against five operations
of a group: ``psum``, ``pmin``, ``pmax``, ``ppermute(pairs)`` and
``all_gather(axis, tiled)``. Each takes the list of the shards' tensors that
this process holds, in the order of ``group.ranks`` (their indices on the
axis), and returns a list in the same order, each result on its shard's
device.

- ``LocalGroup``: every shard of the axis is in this process, one a device
  (devices may repeat). The copies are ``.to(device)``.
- ``ProcessGroup``: one shard a rank of a ``torch.distributed`` group (gloo
  on the CPU, NCCL on CUDA), over ``all_gather_flat`` (``all_gather_single``,
  or ``all_gather_into_tensor`` before it), ``all_reduce`` and
  ``batch_isend_irecv``.

A float ``psum`` adds the parts in the order of the axis, shard 0 first,
in both groups: ``ProcessGroup`` gathers the parts and adds them itself
rather than taking the backend's SUM, whose order is the backend's. So a
sum never depends on timing or on the group, and the two groups' meshes
agree bit for bit. ``ppermute`` follows ``jax.lax.ppermute``: a shard that
no pair sends to receives zeros.
"""

from __future__ import annotations

import torch


def all_gather_flat(out, t, group=None) -> None:
    """Every rank's 1-D ``t`` into ``out`` [world * len(t)], in rank order:
    ``torch.distributed.all_gather_single`` where the installed PyTorch has
    it, else its older name ``all_gather_into_tensor``."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)


class LocalGroup:
    """The shards of one mesh axis held by this process: shard i on
    ``devices[i]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.ranks = list(range(self.size))

    def psum(self, parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return [total.to(d) for d in self.devices]

    def pmin(self, parts):
        return self._fold(parts, torch.minimum)

    def pmax(self, parts):
        return self._fold(parts, torch.maximum)

    def _fold(self, parts, op):
        acc = parts[0]
        for p in parts[1:]:
            acc = op(acc, p.to(acc.device))
        return [acc.to(d) for d in self.devices]

    def ppermute(self, parts, pairs):
        out = [torch.zeros_like(p) for p in parts]
        for src, dst in pairs:
            out[dst] = parts[src].to(self.devices[dst])
        return out

    def all_gather(self, parts, axis: int, tiled: bool = True):
        home = self.devices[0]
        moved = [p.to(home) for p in parts]
        full = torch.cat(moved, dim=axis) if tiled else torch.stack(moved, dim=axis)
        return [full.to(d) for d in self.devices]


class ProcessGroup:
    """One shard of a mesh axis a rank of the ``torch.distributed`` group
    ``group`` (None: the default group); this process holds shard
    ``rank`` on ``device``."""

    def __init__(self, device, group=None):
        import torch.distributed as dist

        self.dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.ranks = [dist.get_rank(group)]
        self.devices = [torch.device(device)]

    def _peer(self, rank: int) -> int:
        """The global rank of the group's ``rank``."""
        if self.group is None:
            return rank
        return self.dist.get_global_rank(self.group, rank)

    def _gather(self, t):
        """[size, *t.shape]: every rank's ``t``, in rank order."""
        t = t.contiguous()
        out = torch.empty(self.size * t.numel(), dtype=t.dtype, device=t.device)
        all_gather_flat(out, t.reshape(-1), self.group)
        return out.view(self.size, *t.shape)

    def psum(self, parts):
        (p,) = parts
        g = self._gather(p)
        total = g[0]
        for i in range(1, self.size):
            total = total + g[i]
        return [total]

    def pmin(self, parts):
        return self._reduce(parts, self.dist.ReduceOp.MIN)

    def pmax(self, parts):
        return self._reduce(parts, self.dist.ReduceOp.MAX)

    def _reduce(self, parts, op):
        (p,) = parts
        out = p.clone()
        self.dist.all_reduce(out, op=op, group=self.group)
        return [out]

    def ppermute(self, parts, pairs):
        (p,) = parts
        me = self.ranks[0]
        p = p.contiguous()
        out = torch.zeros_like(p)
        ops = []
        for src, dst in pairs:
            if src == me and dst == me:
                out = p.clone()
            elif src == me:
                ops.append(self.dist.P2POp(self.dist.isend, p, self._peer(dst), self.group))
            elif dst == me:
                ops.append(self.dist.P2POp(self.dist.irecv, out, self._peer(src), self.group))
        if ops:
            for work in self.dist.batch_isend_irecv(ops):
                work.wait()
        return [out]

    def all_gather(self, parts, axis: int, tiled: bool = True):
        (p,) = parts
        g = self._gather(p)
        if not tiled:
            return [g.movedim(0, axis)]
        return [torch.cat(list(g.unbind(0)), dim=axis)]
