"""The device mesh over torch.distributed ranks and the collectives the
model uses on it (counterpart of ``mp_hsir_tpu/parallel/mesh.py`` and of the
``jax.lax`` collectives its modules call).

The mesh is (data, spatial), rank = d * spatial + s, as JAX reshapes its
devices. ``spatial`` block-shards the H axis of every feature map: convs
read one halo row from each neighbour, shifted windows move boundary rows
around the ring, and the spectral attention sums its pixel statistics over
the axis. ``data`` shards the batch. An :class:`Axis` is one rank's view of
one mesh axis (its process group, its index and the axis size); ``None``
stands for an unsharded axis everywhere.

Collectives (:func:`psum`, :func:`ring_next`, :func:`ring_prev`,
:func:`edge_rows`, :func:`gather_rows`) move small tensors: a few rows, the
spectral sums. Under NCCL they stay on the card; under gloo (ranks sharing
a card, or the CPU) they run on host copies, which gloo takes for every
collective. Each is one ``all_gather``, summed or picked in rank order, so
every rank holds the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One rank's view of a mesh axis: ``index`` of ``size`` members of
    ``group``; ``host``: collectives run on host copies (gloo)."""

    name: str
    index: int
    size: int
    group: Optional[object]
    host: bool


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    spatial: int
    axes: dict

    def axis(self, name: str) -> Optional[Axis]:
        """The axis, or None where it has one member (nothing to shard)."""
        ax = self.axes[name]
        return ax if ax.size > 1 else None


def make_mesh(data: int = 1, spatial: int = 1) -> Mesh:
    """The (data, spatial) mesh of the process group's ranks (rank = d *
    spatial + s). Every rank calls it, in the same order as every other
    collective set-up."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * spatial != world:
        raise ValueError(f"a {data} x {spatial} mesh needs {data * spatial} ranks, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    host = dist.is_initialized() and dist.get_backend() == "gloo"
    d, s = divmod(rank, spatial)

    def group(lists):
        """This rank's group of the axis whose members are ``lists``."""
        if len(lists[0]) == 1:
            return None
        if len(lists[0]) == world:
            return dist.group.WORLD
        mine = None
        for r in lists:  # every rank makes every group, in one order
            g = dist.new_group(r)
            if rank in r:
                mine = g
        return mine

    sp = group([[i * spatial + j for j in range(spatial)] for i in range(data)])
    dp = group([[i * spatial + j for i in range(data)] for j in range(spatial)])
    return Mesh(data, spatial, {SPATIAL_AXIS: Axis(SPATIAL_AXIS, s, spatial, sp, host),
                                DATA_AXIS: Axis(DATA_AXIS, d, data, dp, host)})


def axis_index(ax: Optional[Axis]) -> int:
    return 0 if ax is None else ax.index


def axis_size(ax: Optional[Axis]) -> int:
    return 1 if ax is None else ax.size


def all_gather(t: torch.Tensor, ax: Axis) -> list:
    """Every member's ``t`` (same shape everywhere), in axis order, on t's
    device."""
    src = t.detach().contiguous()
    if ax.host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return [p.to(t.device) for p in parts] if ax.host else parts


def psum(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum of ``t`` over the axis, added in axis order (the same bits on
    every member)."""
    if axis_size(ax) == 1:
        return t
    parts = all_gather(t, ax)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def ring_next(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``ppermute`` one step down the ring: member i receives member i-1's
    ``t`` (member 0 the last one's)."""
    return all_gather(t, ax)[(ax.index - 1) % ax.size]


def ring_prev(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``ppermute`` one step up the ring: member i receives member i+1's."""
    return all_gather(t, ax)[(ax.index + 1) % ax.size]


def edge_rows(x: torch.Tensor, ax: Optional[Axis], rows: int = 1):
    """The ``rows`` rows of the H axis (dim 1) of the neighbours around this
    shard of x: (above: member i-1's last rows, below: member i+1's first
    rows, top edge, bottom edge), the edge flags true where this shard
    holds the image's first / last row. At an edge the ring's wrapped rows
    stand in (the flag says they are not the image's). One all_gather."""
    if axis_size(ax) == 1:
        return x[:, -rows:], x[:, :rows], True, True
    parts = all_gather(torch.cat([x[:, :rows], x[:, -rows:]], dim=1), ax)
    i, n = ax.index, ax.size
    above = parts[(i - 1) % n][:, rows:]
    below = parts[(i + 1) % n][:, :rows]
    return above, below, i == 0, i == n - 1


def gather_rows(x: torch.Tensor, ax: Optional[Axis], dim: int = 1) -> torch.Tensor:
    """The whole map on every member: the shards of x stacked along ``dim``
    in axis order."""
    if axis_size(ax) == 1:
        return x
    return torch.cat(all_gather(x, ax), dim=dim)


def _src(ax: Axis) -> int:
    """The global rank of the axis's member 0."""
    return dist.get_global_rank(ax.group, 0) if ax.group is not dist.group.WORLD else 0


def broadcast(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Member 0's ``t`` on every member (each passes a tensor of the same
    shape and type)."""
    if axis_size(ax) == 1:
        return t
    buf = t.detach().cpu() if ax.host else t.detach().contiguous()
    dist.broadcast(buf, _src(ax), group=ax.group)
    return buf.to(t.device) if ax.host else buf


def scatter_rows(x: Optional[torch.Tensor], ax: Optional[Axis], block: torch.Tensor,
                 dim: int = 2) -> torch.Tensor:
    """Member 0's ``x`` split into the axis's row blocks along ``dim``, block
    i to member i; ``block`` is an empty tensor of one block's shape, type
    and device on every member (member 0 passes x, the others None)."""
    if axis_size(ax) == 1:
        return x
    out = block.cpu() if ax.host else block
    parts = None
    if ax.index == 0:
        src = x.detach().cpu() if ax.host else x.detach()
        parts = [p.contiguous() for p in src.chunk(ax.size, dim=dim)]
    dist.scatter(out, parts, src=_src(ax), group=ax.group)
    return out.to(block.device) if ax.host else out
