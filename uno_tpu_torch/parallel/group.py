"""Process groups: the counterpart of uno_tpu's `make_mesh`
(uno_tpu/parallel/sharding.py).

uno_tpu lays instances, scenarios or KKT columns over a 1-D device mesh;
the port lays them over the ranks of a torch.distributed process group,
one card a rank (cuda:LOCAL_RANK), NCCL on the card and Gloo on the CPU.
What JAX types as device-varying over the mesh axis is local to a rank
here; `psum` is an all-reduce (SUM), and a masked `psum` that only carries
an owner's data is a broadcast from the owner, which is exact.

`make_group(device)` returns the default group when one exists (set up by
the caller, or by torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), else starts a one-process group on an in-memory store.  On
the card a group that is not NCCL, or an NCCL that fails, raises: nothing
falls back to Gloo or to a path without a group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Group:
    """A process group as this rank sees it: its rank, the group's size,
    the device its tensors live on and the backend; `pg` is a subgroup's
    handle (subgroup()), None for the default group."""
    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Any = None

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """t reduced over the ranks (in place), returned."""
        dist.all_reduce(t, op=_OPS[op], group=self.pg)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's t on every rank (in place), returned."""
        if self.pg is not None:
            src = dist.get_global_rank(self.pg, src)
        dist.broadcast(t, src=src, group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t concatenated along dim 0 in rank order; each rank
        gives a tensor of the same shape."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts, dim=0)

    def barrier(self) -> None:
        dist.barrier(group=self.pg)

    def local_range(self, total: int) -> tuple[int, int]:
        """This rank's contiguous run [start, stop) of `total` items, as a
        mesh axis's PartitionSpec splits them: total must be a multiple of
        the world size."""
        if total % self.size:
            raise ValueError(f"{total} items do not split over {self.size} ranks")
        per = total // self.size
        return self.rank * per, (self.rank + 1) * per


def make_group(device="cuda") -> Group:
    """The process group and this rank's device: "cuda" (the default: the
    card cuda:LOCAL_RANK, NCCL) or "cpu" (Gloo)."""
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"device {device!r}: a group runs on cuda or cpu")
    backend = BACKENDS[dev.type]
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "for a Gloo group on the CPU")
        local = dev.index if dev.index is not None else int(os.environ.get(
            "LOCAL_RANK", int(os.environ.get("RANK", 0)) % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        # a CUDA device binds the NCCL communicator to this rank's card
        bind = {"device_id": dev} if dev.type == "cuda" else {}
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://", **bind)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **bind)
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the default process group runs {have!r}; tensors "
                           f"on {dev.type} need {backend!r}")
    group = Group(dist.get_rank(), dist.get_world_size(), dev, backend)
    # a first collective, so that a backend that cannot run fails here
    group.all_reduce(torch.zeros(1, device=dev))
    return group


def subgroup(group: Group, ranks) -> Group | None:
    """The ranks `ranks` of the default group (in that order) as a Group of
    their own, e.g. the first k ranks to time the same work on fewer cards.
    Every rank of the default group must call it, for every subgroup and in
    the same order (torch.distributed.new_group's rule); a rank outside
    `ranks` gets None."""
    ranks = [int(r) for r in ranks]
    pg = dist.new_group(ranks=ranks, backend=group.backend)
    if group.rank not in ranks:
        return None
    return Group(ranks.index(group.rank), len(ranks), group.device, group.backend, pg)
