"""The ranks of a sharded run, and the collectives among them.

qmf_tpu drives every device from one process and names them with a
``jax.sharding.Mesh``; PyTorch runs one process per rank. A :class:`Mesh`
here is one rank's view of its world: the world size (``size``, as
``Mesh.size`` in qmf_tpu), its rank, its ``torch.device`` and the process
group. The engines reach the group only through its two collectives,
:meth:`Mesh.all_gather_rows` and :meth:`Mesh.all_reduce_sum`, which count
the bytes they move (``Mesh.counts``).

NCCL serves CUDA tensors and gloo CPU tensors; gloo also takes CUDA tensors
(several ranks sharing one card, where NCCL refuses two ranks a device),
which it moves through host memory itself.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# all_gather_single is all_gather_into_tensor's newer name
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _zero_counts() -> dict:
    return {"all_gather_bytes": 0, "all_reduce_bytes": 0, "calls": 0}


def local_rank(rank: int = 0) -> int:
    """This process's rank on its host: LOCAL_RANK (torchrun and
    launch.spawn set it), else ``rank``."""
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(device: str | torch.device, local: int) -> torch.device:
    """The device of the rank with local rank ``local``: a bare "cuda" is
    the card of that number (one card a rank, as NCCL needs), an indexed
    device or the CPU is itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if local >= count:
            raise ValueError(
                f"local rank {local} has no CUDA device of its own "
                f"({count} visible); name one (cuda:N) to share it over gloo"
            )
        dev = torch.device("cuda", local)
    return dev


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D world of ``size`` ranks (qmf_tpu's mesh
    axis "d"). ``group`` is None only in a world of one without a process
    group, where every collective is the identity. ``counts`` holds the
    bytes of each collective's result on this rank and the calls since
    :meth:`reset_counts`."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    backend: str = "none"
    counts: dict = field(default_factory=_zero_counts, compare=False)

    def reset_counts(self) -> None:
        self.counts.update(_zero_counts())

    def block_bounds(self, n: int) -> Tuple[int, int]:
        """Rows [lo, hi) of this rank's contiguous block of ``n`` rows, which
        the world size divides (qmf_tpu's P(axis) placement)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over "
                             f"{self.size} ranks")
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``'s rows (a view)."""
        lo, hi = self.block_bounds(t.shape[0])
        return t[lo:hi]

    def lanes(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """Rows [lo, hi) of ``rank``'s (default this rank's) share of ``n``
        rows, the shares differing by at most one row."""
        r = self.rank if rank is None else rank
        return r * n // self.size, (r + 1) * n // self.size

    def all_gather_rows(self, x: torch.Tensor,
                        total: Optional[int] = None) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in rank order. Ranks hold
        equal row counts, or, with ``total``, their :meth:`lanes` of
        ``total`` rows (padded to the largest share for the collective)."""
        if self.group is None:
            return x
        sizes = [x.shape[0]] * self.size if total is None else [
            hi - lo for lo, hi in (self.lanes(total, r)
                                   for r in range(self.size))]
        most = max(sizes)
        if x.shape[0] < most:
            x = torch.cat([x, x.new_zeros((most - x.shape[0],
                                           *x.shape[1:]))])
        out = torch.empty((most * self.size, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _all_gather_single(out, x.contiguous(), group=self.group)
        self.counts["all_gather_bytes"] += out.numel() * out.element_size()
        self.counts["calls"] += 1
        if all(s == most for s in sizes):
            return out
        return torch.cat([out[r * most:r * most + s]
                          for r, s in enumerate(sizes)])

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor on ``t``'s device)."""
        if self.group is None:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        self.counts["all_reduce_bytes"] += out.numel() * out.element_size()
        self.counts["calls"] += 1
        return out


def available_devices(device: str | torch.device) -> Optional[int]:
    """Devices a world may take one each of: the visible CUDA devices for
    a CUDA device; None for the CPU, which has no device count."""
    return (torch.cuda.device_count()
            if torch.device(device).type == "cuda" else None)


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device: Optional[str | torch.device] = None) -> Mesh:
    """This rank's Mesh over the initialized process group (launch.spawn,
    torchrun through multihost.initialize), or, with none, a world of one.

    ``n_devices`` (default: the whole world) must be the world size; a
    larger request raises as qmf_tpu's make_mesh does. ``device`` defaults
    to "cuda" under NCCL and "cpu" otherwise; a bare "cuda" becomes the
    card of this rank's local rank. ``backend`` checks the group's.
    """
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        group_backend = str(dist.get_backend())
        if backend is not None and backend != group_backend:
            raise ValueError(f"asked for {backend}, the process group runs "
                             f"{group_backend}")
        if n_devices is not None and n_devices > world:
            raise ValueError(
                f"requested {n_devices} devices, only {world} available")
        if n_devices is not None and n_devices != world:
            raise ValueError(f"requested {n_devices} devices, the process "
                             f"group has {world} ranks")
        dev = rank_device(
            device or ("cuda" if group_backend == "nccl" else "cpu"),
            local_rank(rank))
        return Mesh(world, rank, dev, dist.group.WORLD, group_backend)
    dev = torch.device(device or "cuda")
    avail = available_devices(dev) or 1
    if n_devices is not None and n_devices > avail:
        raise ValueError(
            f"requested {n_devices} devices, only {avail} available")
    if n_devices not in (None, 1):
        raise ValueError(
            f"requested {n_devices} devices from one process: start one "
            "rank per device (parallel.launch.spawn, or torchrun)")
    return Mesh(1, 0, rank_device(dev, 0))
