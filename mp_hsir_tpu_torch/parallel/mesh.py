"""The device mesh over torch.distributed ranks and the collectives the
model uses on it (counterpart of ``mp_hsir_tpu/parallel/mesh.py`` and of the
``jax.lax`` collectives its modules call).

The mesh is (data, spatial, spectral), rank = (d * spatial + s) * spectral +
t, as JAX reshapes its devices. ``spatial`` block-shards the H axis of every
feature map: convs read one halo row from each neighbour, shifted windows
move boundary rows around the ring, and the spectral attention sums its
pixel statistics over the axis. ``data`` shards the batch. ``spectral``
runs the C x C spectral attentions head-parallel: each member computes its
block of heads and the partial outputs are summed over the axis
(``parallel/tp.py``); everything else is replicated over it. An
:class:`Axis` is one rank's view of one mesh axis (its process group, its
index and the axis size); ``None`` stands for an unsharded axis everywhere.

Collectives (:func:`psum`, :func:`ring_next`, :func:`ring_prev`,
:func:`edge_rows`, :func:`gather_rows`) move small tensors: a few rows, the
spectral sums; only the spectral axis's psum moves whole maps (a member's
partial attention output). Under NCCL they stay on the card; under gloo (ranks sharing
a card, or the CPU) they run on host copies, which gloo takes for every
collective (:func:`all_gather` makes them, the one place that does). Each
is one ``all_gather``, summed or picked in rank order, so every rank holds
the same bits; no collective uses ``send`` / ``recv`` (a CUDA tensor's
``send`` aborts under gloo).

They are differentiable, each an ``autograd.Function`` whose backward is
the transpose JAX takes of ``psum`` / ``ppermute``, again one
``all_gather``: psum's is the psum of the cotangent, ring_next's is
ring_prev and back, edge_rows' adds the cotangent of ``above`` to member
i-1's last rows and that of ``below`` to member i+1's first rows (never
through the ring's wrap at an image edge, whose rows the forward's callers
replace or ignore), gather_rows' is this member's block of the summed
cotangent.

A backward collective must run on every member whenever it runs on one,
or the members whose run skips it wait for ever. That holds by
construction: every member runs the same code on blocks of the same shape,
so its graph holds the same collective nodes, created in the same order;
every output of a collective feeds the member's loss on every member (the
only outputs a caller drops are edge_rows' wrapped rows at an image edge,
and with two or more members no member is at both edges, so the other
output is used); and the autograd engine runs the nodes of one device in
sequence-number order, the same on every member. Nothing collective
happens in a hook or in data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
SPECTRAL_AXIS = "spectral"
# every rank of the mesh, data x spatial x spectral (JAX's pmean over every
# axis)
MESH_AXES = "every"


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
    spectral: int = 1

    def axis(self, name: str) -> Optional[Axis]:
        """The axis, or None where it has one member (nothing to shard)."""
        ax = self.axes[name]
        return ax if ax.size > 1 else None


def make_mesh(data: int = 1, spatial: int = 1, spectral: int = 1) -> Mesh:
    """The (data, spatial, spectral) mesh of the process group's ranks (rank
    = (d * spatial + s) * spectral + t). Every rank calls it, in the same
    order as every other collective set-up."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * spatial * spectral != world:
        raise ValueError(f"a {data} x {spatial} x {spectral} mesh needs "
                         f"{data * spatial * spectral} ranks, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    host = dist.is_initialized() and dist.get_backend() == "gloo"
    d, rest = divmod(rank, spatial * spectral)
    s, t = divmod(rest, spectral)

    def at(i, j, k):
        return (i * spatial + j) * spectral + k

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

    sp = group([[at(i, j, k) for j in range(spatial)] for i in range(data)
                for k in range(spectral)])
    dp = group([[at(i, j, k) for i in range(data)] for j in range(spatial)
                for k in range(spectral)])
    tp = group([[at(i, j, k) for k in range(spectral)] for i in range(data)
                for j in range(spatial)])
    return Mesh(data, spatial, {SPATIAL_AXIS: Axis(SPATIAL_AXIS, s, spatial, sp, host),
                                DATA_AXIS: Axis(DATA_AXIS, d, data, dp, host),
                                SPECTRAL_AXIS: Axis(SPECTRAL_AXIS, t, spectral, tp, host),
                                MESH_AXES: Axis(MESH_AXES, rank, world,
                                                dist.group.WORLD if world > 1 else None, host)},
                spectral)


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


def _sum(parts: list) -> torch.Tensor:
    """parts[0] + parts[1] + ..., added in axis order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return _sum(all_gather(t, ax))

    @staticmethod
    def backward(ctx, g):
        return _sum(all_gather(g, ctx.ax)), None


class _Ring(torch.autograd.Function):
    """Member i receives member i - step's t (around the ring)."""

    @staticmethod
    def forward(ctx, t, ax, step):
        ctx.ax, ctx.step = ax, step
        return all_gather(t, ax)[(ax.index - step) % ax.size]

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return all_gather(g, ax)[(ax.index + ctx.step) % ax.size], None, None


class _EdgeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, rows):
        ctx.ax, ctx.rows, ctx.shape = ax, rows, x.shape
        parts = all_gather(torch.cat([x[:, :rows], x[:, -rows:]], dim=1), ax)
        i, n = ax.index, ax.size
        return parts[(i - 1) % n][:, rows:], parts[(i + 1) % n][:, :rows]

    @staticmethod
    def backward(ctx, d_above, d_below):
        ax, rows = ctx.ax, ctx.rows
        i, n = ax.index, ax.size
        parts = all_gather(torch.cat([d_above, d_below], dim=1), ax)
        dx = d_above.new_zeros(ctx.shape)
        if i > 0:  # member i-1's below was this member's first rows
            dx[:, :rows] += parts[i - 1][:, rows:]
        if i < n - 1:  # member i+1's above was this member's last rows
            dx[:, -rows:] += parts[i + 1][:, :rows]
        return dx, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(all_gather(x, ax), dim=dim)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return _sum(all_gather(g, ax)).chunk(ax.size, dim=ctx.dim)[ax.index].contiguous(), None, None


def psum(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum of ``t`` over the axis, added in axis order (the same bits on
    every member)."""
    if axis_size(ax) == 1:
        return t
    return _Psum.apply(t, ax)


def ring_next(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``ppermute`` one step down the ring: member i receives member i-1's
    ``t`` (member 0 the last one's)."""
    return _Ring.apply(t, ax, 1)


def ring_prev(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``ppermute`` one step up the ring: member i receives member i+1's."""
    return _Ring.apply(t, ax, -1)


def edge_rows(x: torch.Tensor, ax: Optional[Axis], rows: int = 1):
    """The ``rows`` rows of the H axis (dim 1) of the neighbours around this
    shard of x: (above: member i-1's last rows, below: member i+1's first
    rows, top edge, bottom edge), the edge flags true where this shard
    holds the image's first / last row. At an edge the ring's wrapped rows
    stand in (the flag says they are not the image's; the backward sends
    nothing through the wrap). One all_gather."""
    if axis_size(ax) == 1:
        return x[:, -rows:], x[:, :rows], True, True
    above, below = _EdgeRows.apply(x, ax, rows)
    return above, below, ax.index == 0, ax.index == ax.size - 1


def gather_rows(x: torch.Tensor, ax: Optional[Axis], dim: int = 1) -> torch.Tensor:
    """The whole map on every member: the shards of x stacked along ``dim``
    in axis order."""
    if axis_size(ax) == 1:
        return x
    return _GatherRows.apply(x, ax, dim)


def pmean_(tensors: list, ax: Optional[Axis]) -> None:
    """JAX's ``pmean`` of each tensor over the axis, in place, as one
    flattened float32 bucket: one all_gather, the members' buckets added in
    axis order and divided by the size, so every member holds the same
    bits. Outside autograd (the train step's gradients and loss)."""
    n = axis_size(ax)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = _sum(all_gather(flat, ax)) / n
    o = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[o:o + k].view_as(t))
        o += k


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
