"""Spectral (C x C, MDTA) attention as two kernels around a small fold.

Kernels: ``csrc/spectral.cu`` — ``mp_spectral_stats`` (the Gram and norm
sums: phase 0 of ``_spectral_kernel`` and the spectral half of
``_nhwc_sp0_kernel``, ``mp_hsir_tpu/ops/pallas_attention.py:1429`` and
``:362``; on the training route ``_sp0_kernel``, ``:1926``) and
``mp_spectral_apply`` (phase 1 with its epilogues, ``:1429``; on the training
route ``_sp1_kernel`` with its drop-path scale, ``:1962``). :func:`spectral_fold`
turns the sums into the C x C ``comb`` matrix in PyTorch, as
``spectral_sharded_fold`` (``:2125``) does on the JAX split route; autograd
differentiates it.

Backward (training): ``mp_spectral_stats_bwd`` and ``mp_spectral_apply_bwd``
plus the shared stages of ``csrc/grad.cu`` replace ``_sp0_bwd_kernel`` /
``_sp1_bwd_kernel`` (``mp_hsir_tpu/ops/pallas_vjp.py:1443``, ``:1501``) and
the two phases of ``_spectral_bwd_kernel`` (``:953``). On a row shard the
launches of both types take the halo rows as the forward's do and return
their cotangents (``dtop`` / ``dbot`` of ``_sp0_bwd_kernel`` /
``_sp1_bwd_kernel``, which ``_halo_grads``, ``:1783``, sends back to the
neighbour shards): the first launch also writes the halo rows' LN'd input
and 1x1 output; the depthwise backward (grad.cu's in float32, the
tensor-core tile in bf16) reads t as zero beyond the shard, and grad.cu's
``mp_dwconv_halo_bwd`` adds the halo rows' tap partials and cotangents in
both types; then grad.cu's 1x1 + LayerNorm backward carries the cotangent to
the raw rows (:func:`_halo_rows_bwd`). The halo rows are tensor inputs of
the autograd Functions, so their cotangents travel back through the
exchange that brought them. The bf16 stats
backward runs two tensor-core tiles instead of ``mp_spectral_stats_bwd`` and
grad.cu's depthwise and LayerNorm stages: ``mp_spectral_stats_bwd_tc`` (the
forward tile's front and dq | dk, ``csrc/spectral_stats.cuh``) and
``mp_dwconv_dx_tc`` (the transposed stencil, dx and the LayerNorm backward,
``csrc/dwconv_dx.cuh``), then the weight product and one in-order sum of the
per-tile partials (:func:`stats_bwd_tc_plan` mirrors both plans). The bf16
apply backward runs two tensor-core tiles too, instead of
``mp_spectral_apply_bwd`` and grad.cu's depthwise and LayerNorm stages:
``mp_spectral_apply_bwd_tc`` (v recomputed by the forward front's pieces,
then dv and the drop-path product from one staged comb tile,
``csrc/spectral_apply_bwd.cuh``) and ``mp_spectral_apply_dx_tc`` (the same
second tile at K = C with the extra input cotangent in its epilogue), then
``mp_spectral_gate_grad`` (per-window gates, or per pixel for a row
shard's gate map), the two weight products and the in-order sums of
the per-tile partials (:func:`apply_bwd_tc_plan` mirrors both plans). The
eval-only options (``x2``, the ``mlp`` tail) have no backward, as in the JAX
package; a backward through them raises.

Layouts at these functions: NHWC maps; wqkv (3C, C, 1, 1) and wdw
(3C, 1, 3, 3) conv weights; the optional second input ``x2`` makes the
logical input ``cat([x, x2], -1)``; ``shift`` > 0 means ``x`` is in the
rolled frame of a shifted block and is read through the roll-back.

A member's head block under the spectral mesh axis (``parallel/tp.py``,
:func:`spectral_attention_tp`): wqkv (3CL, C, 1, 1) and wdw (3CL, 1, 3,
3) hold its heads' q, k and v rows, CL = wqkv.shape[0] / 3 < C (the q/k/v
width comes from the weight, as in ``_sp0_kernel`` / ``_sp1_kernel``), the
stats are (B, CL, dh), comb is (B, CL, C) and the apply's output the
member's partial projection; the weight cotangents are (3CL, C). The
launches of all four kernels take it in both types (one ``CL`` argument in
each C entry, the head-block plans keyed on (C, CL) beside the whole
attention's, launches counted in :data:`STATS_TP`, :data:`APPLY_TP` and
their backward twins too): the bf16 tiles stream the member's q/k/v rows
and comb (B, CL, C) as the whole attention's tiles stream theirs.

The stats launch runs a tensor-core tile in both types: bf16 the tile of
``csrc/spectral_stats.cuh`` (C up to :data:`FRONT_MAX_C`), float32 the 3xTF32
tile of ``csrc/spectral_stats_f32.cuh`` (heads up to 96 wide; its launches
counted in :data:`F32_TILE` too). Both stream the q|k rows of the torch
weights as they are (:func:`pack_stats`), in the head groups that
:func:`stats_plan` and :func:`stats_f32_plan` describe, and sum their per-part
partials in one more launch. The apply launch runs a tensor-core tile in
both types too: bf16 the tile of ``csrc/spectral_front.cuh`` (C up to
:data:`FRONT_MAX_C`), which streams the v rows of the torch weights and a
bf16 copy of ``comb`` as they are (:func:`pack_front`), in the tiles that
:func:`front_plan` describes; float32 the 3xTF32 tile
``spectral_apply_f32_kernel`` (``csrc/spectral.cu``, built from
``csrc/spectral_front_f32.cuh``; any C whose plan fits), which streams the
same v rows and ``comb`` transposed (:func:`pack_front_f32`) in the chunks
that :func:`apply_f32_plan` describes, its launches counted in
:data:`APPLY_F32` too. Their PGSSTB tail runs the tail tile of
``csrc/mlp_tail.cuh`` in the same type on
:func:`~mp_hsir_tpu_torch.ops.kernels.mlp.pack_mlp_weights`' packs (the
float32 one counted in ``mlp.TAIL_F32`` too).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._grad import (
    dwconv3_bwd_plain, dwconv3_f32, dwconv_bwd, dwconv_halo_bwd, grad_or_zeros, ln_bwd_plain,
    ln_linear_bwd, ln_stats, sum_parts, wgrad,
)
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.kernels.mlp import TAIL_F32, pack_mlp_weights, tail_f32_plan
from mp_hsir_tpu_torch.ops.window import roll_hw
from mp_hsir_tpu_torch.parallel.mesh import Axis, axis_size, edge_rows, psum

STATS = counter("spectral_stats")
F32_TILE = counter("spectral_stats_f32")
APPLY = counter("spectral_apply")
APPLY_F32 = counter("spectral_apply_f32")
# the launches of a row shard with real halo rows, keyed by the compute type:
# ("spectral_stats_halo", B, H, W, C1, C2, heads, LN, halo bits, dtype) and
# ("spectral_apply_halo", B, H, W, C1, C2, halo bits, dtype)
STATS_HALO = counter("spectral_stats_halo")
APPLY_HALO = counter("spectral_apply_halo")
STATS_BWD = counter("spectral_stats_bwd")
APPLY_BWD = counter("spectral_apply_bwd")
# the backward launches of a row shard with real halo rows, which return the
# halo rows' cotangents: ("spectral_stats_bwd_halo", B, H, W, C, heads, LN,
# halo bits, dtype) and ("spectral_apply_bwd_halo", B, H, W, C, LN, residual,
# gate, dp, halo bits, dtype)
STATS_BWD_HALO = counter("spectral_stats_bwd_halo")
APPLY_BWD_HALO = counter("spectral_apply_bwd_halo")
# the launches of a member's head block under the spectral mesh axis (q/k/v
# width CL < C): ("spectral_stats_tp", B, H, W, C, CL, heads, halo bits,
# dtype), ("spectral_apply_tp", B, H, W, C, CL, gate, dp, halo bits, dtype)
# and their backward twins
STATS_TP = counter("spectral_stats_tp")
APPLY_TP = counter("spectral_apply_tp")
STATS_BWD_TP = counter("spectral_stats_bwd_tp")
APPLY_BWD_TP = counter("spectral_apply_bwd_tp")
# the bf16 apply tile (csrc/spectral_front.cuh): its widest C (kFrontMaxC),
# the 16 x 32 output units a warp holds (kFrontUnits), the halo rows padded to
# 7 row tiles (kFrontRows) and the weight tiles' depth
FRONT_MAX_C = 384
FRONT_UNITS = 3
FRONT_ROWS = 112
FRONT_K = 64
FRONT_LDW = 72  # a weight tile's row: 64 deep + 8 (kFrontLdw)
# the bf16 stats tile (csrc/spectral_stats.cuh): a pass's widest column count
# (kStatsMaxN) and the dynamic shared memory its plan may take (kStatsBudget)
STATS_MAX_N = 192
STATS_BUDGET = 232448 - 1024
# the float32 stats tile (csrc/spectral_stats_f32.cuh): a column group's widest
# count (kStatsF32MaxN), a ring stage's channels and row (kF32K, kF32Ld), the
# kernel's static shared memory (the halo rows' source pixels)
STATS_F32_MAX_N = 192
F32_K = 32
F32_LD = 36
STATS_F32_STATIC = 448
# the float32 apply tile (spectral_apply_f32_kernel, csrc/spectral.cu): a v
# column group's widest count (kApplyF32MaxGW), a comb pass's (kCombMaxN),
# the dynamic shared memory its plan may take (kApplyF32Budget) and the
# kernel's static shared memory (the halo rows' and tile pixels' sources)
APPLY_F32_MAX_GW = 192
COMB_MAX_N = 384
APPLY_F32_BUDGET = 232448 - 1024
APPLY_F32_STATIC = 960
# the bf16 backward's second tile (csrc/dwconv_dx.cuh): the row strides of
# its dout (float32) and t / dt (bf16) chunks (kDxLdd, kDxLdt)
DX_LDD = 68
DX_LDT = 72

__all__ = ["Halo", "dwconv3_f32", "shard_halo", "spectral_apply", "spectral_attention_sharded",
           "spectral_attention_tp", "spectral_fold", "spectral_stats"]


class Halo(NamedTuple):
    """The neighbour rows of one row shard of a map (the counterpart of the
    ``halo_top`` / ``halo_bot`` / ``edge`` arguments of ``_sp0_call`` and
    ``_sp1_call``, ``mp_hsir_tpu/ops/pallas_attention.py:2027``, ``:2072``):
    ``top`` and ``bot`` (B, 1, W, C) are the raw rows just above and just
    below the shard, of the logical input ``cat(x, x2)``; ``edge_top`` /
    ``edge_bot`` say that the shard's top / bottom row is the image's, and
    the row beyond it is then zero after the LayerNorm, whatever ``top`` /
    ``bot`` hold. A halo row that is not at an edge is real data: it goes
    through the LayerNorm and the 1x1, and feeds the depthwise 3x3 of the
    shard's first or last row only."""

    top: torch.Tensor
    bot: torch.Tensor
    edge_top: bool
    edge_bot: bool

    @property
    def flags(self) -> int:
        """The kernels' halo bits: 1 the row above is real, 2 the row below."""
        return (0 if self.edge_top else 1) | (0 if self.edge_bot else 2)


def _input(x, x2, shift, ln_w, ln_b, eps, halo=None):
    """(raw, normalised) logical input in the unrolled frame, and the
    normalised (top, bottom) halo rows, zero at an image edge (None without
    a halo)."""
    u = roll_hw(x, shift, shift) if shift else x
    if x2 is not None:
        u = torch.cat([u, x2], dim=-1)
    norm = (lambda t: layer_norm(t, ln_w, ln_b, eps)) if ln_w is not None else (lambda t: t)
    rows = None
    if halo is not None:
        if shift:
            raise ValueError("a row shard is read in its own frame: halo rows take shift 0")
        rows = tuple(torch.zeros_like(u[:, :1]) if edge else norm(r.to(u.dtype))
                     for r, edge in ((halo.top, halo.edge_top), (halo.bot, halo.edge_bot)))
    return u, norm(u), rows


def _qkv_part(u, wqkv, wdw, lo, hi, dt, rows=None):
    """(t, dw3x3(t)) with t = 1x1(u)[..., lo:hi], rounded to dt where the
    kernels round (float32 tensors of dt values). ``rows``: the normalised
    (top, bottom) halo rows, which the depthwise reads above and below u."""
    c = u.shape[-1]
    if rows is not None:
        u = torch.cat([rows[0], u, rows[1]], dim=1)
    t = (u.float() @ wqkv[lo:hi].reshape(hi - lo, c).to(dt).float().t()).to(dt).float()
    v = dwconv3_f32(t, wdw[lo:hi].to(dt)).to(dt).float()
    if rows is not None:
        t, v = t[:, 1:-1], v[:, 1:-1]
    return t, v


def _qkv_bwd(raw, u, rows, halo, wqkv, wdw, lo, hi, dt, dout, ln_w, eps):
    """Explicit VJP of :func:`_qkv_part`'s depthwise output (channels
    ``lo:hi``) at cotangent ``dout`` (B, H, W, K) float32, through the 1x1
    and the optional LayerNorm: returns (d raw (B, H, W, C) float32, in the
    unrolled frame, d 1x1 weight (K, C), d taps (K, 1, 3, 3), d ln_w, d
    ln_b, d halo.top, d halo.bot). ``rows``: the normalised halo rows of
    :func:`_input`; their t feeds the taps' gradient, and the cotangent of
    their t goes back through the 1x1 and their LayerNorm to the raw halo
    rows (None at an image edge, whose row the forward zeroed after the
    LayerNorm). The weight gradients count the halo rows' share: they are
    this shard's forward."""
    c, k = u.shape[-1], hi - lo
    w1 = wqkv[lo:hi].reshape(k, c).to(dt).float()
    ue = u if rows is None else torch.cat([rows[0], u, rows[1]], dim=1)
    t = (ue.float() @ w1.t()).to(dt).float()
    de = dout if rows is None else F.pad(dout, (0, 0, 0, 0, 1, 1))
    dtt, dwdw = dwconv3_bwd_plain(de, t, wdw[lo:hi].to(dt))
    dtt = dtt.to(dt).float()
    dw = dtt.reshape(-1, k).t() @ ue.float().reshape(-1, c)
    du = dtt @ w1
    xe = raw
    if rows is not None:
        keep = [0.0 if halo.edge_top else 1.0, 0.0 if halo.edge_bot else 1.0]
        du = torch.cat([du[:, :1] * keep[0], du[:, 1:-1], du[:, -1:] * keep[1]], dim=1)
        xe = torch.cat([halo.top.to(raw.dtype), raw, halo.bot.to(raw.dtype)], dim=1)
    dlnw = dlnb = None
    if ln_w is not None:
        du, dlnw, dlnb = ln_bwd_plain(du, *ln_stats(xe, eps), ln_w)
    dtop = dbot = None
    if rows is not None:
        dtop = None if halo.edge_top else du[:, :1].to(dt)
        dbot = None if halo.edge_bot else du[:, -1:].to(dt)
        du = du[:, 1:-1]
    return du, dw, dwdw, dlnw, dlnb, dtop, dbot


def _no_eval_only_grad(name, **opts):
    bad = [k for k, v in opts.items() if v is not None]
    if bad:
        raise RuntimeError(f"{name}: no backward for the eval-only option(s) {bad} "
                           "(the training route runs without them, as in the JAX package)")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def spectral_stats_plain(x, wqkv, wdw, num_heads: int, shift: int = 0, x2=None,
                         ln_w=None, ln_b=None, eps: float = 1e-5, halo: Halo | None = None):
    """Returns (gram (B, CL, dh), nq (B, nH, dh), nk (B, nH, dh)), float32,
    CL = wqkv.shape[0] / 3 the q/k/v width (C, or a member's head block of
    ``num_heads`` heads under the spectral mesh axis, its q/k/v rows in
    wqkv: ``parallel/tp.py``). ``halo``: x is a row shard (:class:`Halo`);
    the sums cover its rows."""
    _, u, rows = _input(x, x2, shift, ln_w, ln_b, eps, halo)
    b, h, w, _ = u.shape
    cl = wqkv.shape[0] // 3
    dh = cl // num_heads
    qk = _qkv_part(u, wqkv, wdw, 0, 2 * cl, x.dtype, rows)[1].reshape(b, h * w, 2, num_heads, dh)
    q, k = qk[:, :, 0], qk[:, :, 1]
    gram = torch.einsum("bphd,bphe->bhde", q, k).reshape(b, cl, dh)
    return gram, q.square().sum(dim=1), k.square().sum(dim=1)


def spectral_stats_bwd_plain(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk,
                             halo: Halo | None = None):
    """Explicit VJP of :func:`spectral_stats_plain` (one input): returns
    (dx, d wqkv, d wdw, d ln_w, d ln_b, d halo.top, d halo.bot); the v
    sections of the weight cotangents are zero, a halo row's cotangent None
    at an image edge (and without ``halo``)."""
    dt = x.dtype
    raw, u, rows = _input(x, None, shift, ln_w, ln_b, eps, halo)
    b, h, w, c = u.shape
    cl = wqkv.shape[0] // 3
    dh = cl // num_heads
    qk = _qkv_part(u, wqkv, wdw, 0, 2 * cl, dt, rows)[1]
    q = qk[..., :cl].reshape(b, h, w, num_heads, dh)
    k = qk[..., cl:].reshape(b, h, w, num_heads, dh)
    dg = dgram.to(dt).float().reshape(b, num_heads, dh, dh)
    dq = torch.einsum("byxne,bnde->byxnd", k, dg) + 2 * q * dnq.reshape(b, 1, 1, num_heads, dh)
    dk = torch.einsum("byxnd,bnde->byxne", q, dg) + 2 * k * dnk.reshape(b, 1, 1, num_heads, dh)
    dqk = torch.cat([dq.reshape(b, h, w, cl), dk.reshape(b, h, w, cl)], dim=-1)
    du, dw_qk, dwdw_qk, dlnw, dlnb, dtop, dbot = _qkv_bwd(raw, u, rows, halo, wqkv, wdw, 0,
                                                          2 * cl, dt, dqk, ln_w, eps)
    dw = torch.zeros((3 * cl, c), dtype=torch.float32, device=x.device)
    dw[:2 * cl] = dw_qk
    dwdw = torch.zeros((3 * cl, 1, 3, 3), dtype=torch.float32, device=x.device)
    dwdw[:2 * cl] = dwdw_qk
    dx = roll_hw(du, -shift, -shift) if shift else du
    return dx.to(dt), dw.reshape(3 * cl, c, 1, 1), dwdw, dlnw, dlnb, dtop, dbot


def _stats_groups(heads: int, hw: int, fixed: int, hcap: int, wcap: int) -> dict:
    """``StatsGroups`` (csrc/spectral_stats.cuh): groups of at most ``hcap``
    of ``heads`` heads of ``hw`` columns as large as the budget allows, at
    most ``wcap`` ring stages, beside ``fixed`` bytes."""
    hmax = min(max(1, STATS_MAX_N // hw), hcap)
    while True:
        groups = -(-heads // hmax)
        hg = -(-heads // groups)
        gw = hg * hw
        pp = -(-gw // STATS_MAX_N)
        np_ = 32 * -(-(gw // 32) // pp)
        for ws in range(wcap, 1, -1):
            nbytes = fixed + 2 * 64 * (gw + 8) + max(2 * ws * np_ * 72, 2 * 100 * (np_ + 8))
            if nbytes <= STATS_BUDGET:
                break
        if nbytes <= STATS_BUDGET or hmax == 1:
            return dict(hg=hg, groups=groups, gw=gw, np=np_, ws=ws, bytes=nbytes)
        hmax -= 1


def stats_plan(c: int, heads: int, cl: int | None = None) -> dict:
    """The bf16 stats tile's tiling at input width ``c`` and q|k width
    ``cl`` (default ``c``; a member's head block of ``heads`` heads under
    the spectral mesh axis) (``StatsPlan`` in csrc/spectral_stats.cuh): the
    output columns ordered by head, each head ``hw`` = 2 ``dhp`` wide (q,
    then k, dh = cl / heads padded to ``dhp``, a multiple of 16), in
    ``groups`` groups of ``hg`` heads (``gw`` columns), each group's 1x1 in
    passes of ``np`` columns over ``nk`` 64-deep weight tiles (c deep) and
    ``ws`` ring stages; ``cp`` = c rounded up to 32; ``bytes`` the dynamic
    shared memory. A head block takes at most the groups and stages of the
    whole attention's plan at ``c`` (its c / dh heads)."""
    cl = c if cl is None else cl
    dh = cl // heads
    dhp = -(-dh // 16) * 16
    hw, cp = 2 * dhp, -(-c // 32) * 32
    nqk = heads * hw
    halo = 2 * FRONT_ROWS * (cp + 8)
    hcap, wcap = STATS_MAX_N, 3
    if cl < c:
        nw = c // dh
        whole = _stats_groups(nw, hw, 2 * 9 * nw * hw + 4 * nw * dhp * dhp + 4 * nw * hw + halo,
                              STATS_MAX_N, 3)
        hcap, wcap = whole["hg"], whole["ws"]
    g = _stats_groups(heads, hw, 2 * 9 * nqk + 4 * heads * dhp * dhp + 4 * nqk + halo, hcap, wcap)
    return dict(g, dh=dh, dhp=dhp, hw=hw, nqk=nqk, cp=cp, nk=-(-cp // FRONT_K))


def stats_f32_plan(c: int, heads: int, cl: int | None = None) -> dict:
    """The float32 stats tile's tiling at input width ``c`` and q|k width
    ``cl`` (default ``c``; a member's head block of ``heads`` heads under the
    spectral mesh axis) (``StatsF32Plan`` in csrc/spectral_stats_f32.cuh):
    the head-grouped columns of :func:`stats_plan` (``dhp``, ``hw``,
    ``nqk``) in ``groups`` groups of ``hg`` heads (``gw`` columns), the K
    chunks ``nk`` of :data:`F32_K` input channels, ``ws`` ring stages;
    ``dyn`` the dynamic shared memory and ``bytes`` the plan with the static
    (what ``mp_spectral_stats_smem(c, cl, heads)`` returns). ``ok``: a
    head's columns fit one group (dh up to 96)."""
    dh = (c if cl is None else cl) // heads
    dhp = -(-dh // 16) * 16
    hw = 2 * dhp
    hmax = max(1, STATS_F32_MAX_N // hw)
    groups = -(-heads // hmax)
    hg = -(-heads // groups)
    gw = hg * hw
    ldq = gw + 8
    fixed = 4 * (9 * gw + hg * dhp * dhp + gw + 2 * FRONT_ROWS + 64 * ldq)
    for ws in (3, 2):
        dyn = fixed + max(ws * 4 * (FRONT_ROWS + gw) * F32_LD, 4 * 100 * ldq)
        if dyn <= STATS_BUDGET:
            break
    return dict(dh=dh, dhp=dhp, hw=hw, nqk=heads * hw, nk=-(-c // F32_K), hg=hg, groups=groups,
                gw=gw, ldq=ldq, ws=ws, dyn=dyn, bytes=dyn + STATS_F32_STATIC,
                ok=hw <= STATS_F32_MAX_N)


def dwconv_dx_plan(c: int, k: int, stencil: bool = True, f32_t: bool = False) -> dict:
    """The plan of the bf16 backward's second tile at width ``c`` and ``k``
    depthwise channels (``DwDxPlan`` in csrc/dwconv_dx.cuh): ``nck`` 64-channel
    chunks; ``stages`` ring stages (3 where they fit, else 2) of ``stage``
    bytes (the dout and t halo chunks and the chunk's rows of the 1x1 weight,
    ``ck`` = c rounded up to 64 columns); ``bytes`` the dynamic shared memory,
    the dt chunk included. Without the stencil (the window backward's tile
    2, ``k`` = 3C) a stage is the cotangent chunk [64][72] and the weight
    rows, and there is no dt chunk. ``f32_t`` (the GDFN backward's tile 2):
    the t chunk is float32 [100][68], as dout's."""
    ck = -(-c // 64) * 64
    rows = 100 if stencil else 64
    tt = 4 * 100 * DX_LDD if stencil and f32_t else 2 * rows * DX_LDT
    stage = (4 * 100 * DX_LDD if stencil else 0) + tt + 2 * 64 * (ck + 8)
    da = 2 * 64 * DX_LDT if stencil else 0
    stages = 3 if da + 3 * stage <= STATS_BUDGET else 2
    return dict(ck=ck, nck=-(-k // 64), stages=stages, stage=stage, bytes=da + stages * stage)


def stats_bwd_tc_plan(c: int, heads: int, cl: int | None = None) -> dict:
    """The bf16 stats backward's plans at input width ``c`` and q|k width
    ``cl`` (default ``c``): the first tile's (``StatsBwdPlan`` in
    csrc/spectral_stats.cuh: :func:`stats_plan`'s tiling with dG, bf16
    [heads][dhp][``ldg`` = dhp + 8], in the place of the Gram partial;
    ``bytes``) and the second tile's at K = 2CL (``dx``: :func:`dwconv_dx_plan`)."""
    cl = c if cl is None else cl
    pl = stats_plan(c, heads, cl)
    ldg = pl["dhp"] + 8
    dg = 2 * heads * pl["dhp"] * ldg
    return dict(pl, ldg=ldg, bytes=pl["bytes"] - 4 * heads * pl["dhp"] ** 2 + dg,
                dx=dwconv_dx_plan(c, 2 * cl))


def qk_row(n: int, plan: dict, cl: int) -> int:
    """The row of :func:`pack_stats`' q|k weights ([2CL][C8], q rows then k
    rows; ``cl`` the q|k width) behind column ``n`` of the tile's
    head-grouped order (``qk_row`` in csrc/spectral_stats.cuh), or -1 for a
    padding column."""
    h, j = divmod(n, plan["hw"])
    d = j if j < plan["dhp"] else j - plan["dhp"]
    return (0 if j < plan["dhp"] else cl) + h * plan["dh"] + d if d < plan["dh"] else -1


def pack_stats(wqkv, wdw, dt):
    """The operands the stats tiles stream, in ``dt``: the q|k rows of the
    1x1 weight as [2CL out][C8 in] (torch layout) and their depthwise taps
    as [2CL][9] (CL = wqkv.shape[0] / 3: C, or a member's head block); C8 is
    C rounded up to 8, the rows padded with zeros only where C is not a
    multiple of 8 (rows of whole 16-byte vectors for the kernels' copies in
    both types). Views of the weights where they are already in ``dt``."""
    c, cl = wqkv.shape[1], wqkv.shape[0] // 3
    wqk = wqkv[:2 * cl].reshape(2 * cl, c).to(dt)
    if c % 8:
        wqk = F.pad(wqk, (0, -c % 8))
    return wqk.contiguous(), wdw[:2 * cl].reshape(2 * cl, 9).to(dt).contiguous()


@lru_cache(maxsize=None)
def _stats_entry(kind: str = "fwd"):
    import ctypes

    if kind == "bwd":
        return _build.entry("mp_spectral_stats_bwd", 14,
                            [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int])
    if kind == "bwd_tc":
        return _build.entry("mp_spectral_stats_bwd_tc", 14,
                            [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int])
    if kind == "dx_tc":
        return _build.entry("mp_dwconv_dx_tc", 9, [ctypes.c_int] * 6 + [ctypes.c_float])
    return _build.entry("mp_spectral_stats", 11,
                        [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])


@lru_cache(maxsize=None)
def _stats_parts(*shape: int) -> int:
    """The parts per image of a stats launch (``mp_spectral_stats_parts``:
    dtype, B, H, W, C, CL, heads), asked once per shape."""
    import ctypes

    fn = _build.lib().mp_spectral_stats_parts
    fn.argtypes, fn.restype = [ctypes.c_int] * len(shape), ctypes.c_int
    n = int(fn(*shape))
    if n <= 0:
        raise RuntimeError(f"mp_spectral_stats_parts{shape} failed")
    return n


def _halo_operand(halo, x, x2, shift):
    """(the halo rows [2][B][W][C] in x's type, or None; the kernels' halo
    bits). The tiles and backward launches of both types take real halo rows
    (shift 0)."""
    if halo is None or not halo.flags:
        return None, 0
    b, h, w, c1 = x.shape
    c = c1 + (0 if x2 is None else x2.shape[-1])
    if shift:
        raise ValueError("a row shard is read in its own frame: halo rows take shift 0")
    if halo.top.shape != (b, 1, w, c) or halo.bot.shape != (b, 1, w, c):
        raise ValueError(f"halo rows must be {(b, 1, w, c)}, got {tuple(halo.top.shape)} and "
                         f"{tuple(halo.bot.shape)}")
    rows = torch.stack([halo.top[:, 0], halo.bot[:, 0]]).to(x.dtype).contiguous()
    return rows, halo.flags


def _stats_prepare(x, wqkv, wdw, num_heads, shift=0, x2=None, ln_w=None, ln_b=None, eps=1e-5,
                   halo=None):
    """Everything a launch needs: (the C entry's arguments, the outputs, the
    tensors the arguments point into, to be held until the launch). Weights:
    :func:`pack_stats` in the compute type (CL = wqkv.shape[0] / 3 q|k
    rows); ``halo``: the rows of :func:`_halo_operand`."""
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    c = c1 + c2
    cl = wqkv.shape[0] // 3
    if h % 8 or w % 8 or cl % num_heads or wqkv.shape[1] != c or cl > c:
        raise ValueError(f"spectral stats needs H, W % 8 == 0, a (3CL, C) weight with CL <= C "
                         f"and CL % heads == 0, got {tuple(x.shape)} and {tuple(wqkv.shape)}")
    dt, code = x.dtype, dtype_code(x)
    dh = cl // num_heads
    what = f"C={c}, heads={num_heads}" + ("" if cl == c else f", CL={cl}")
    if code:
        if c > FRONT_MAX_C:  # the widest C of the tile's plan
            raise ValueError(f"the bf16 spectral stats kernel takes C up to {FRONT_MAX_C}, got {c}")
        _build.check_plan("spectral_stats", "mp_spectral_stats_tc_smem", what, c, cl, num_heads)
    else:
        if not stats_f32_plan(c, num_heads, cl)["ok"]:  # a head's columns in one group
            raise ValueError(f"the float32 spectral stats kernel takes heads up to 96 wide, "
                             f"got {dh}")
        _build.check_plan("spectral_stats", "mp_spectral_stats_smem", what, c, cl, num_heads)
    rows, flags = _halo_operand(halo, x, x2, shift)
    wq, wd = pack_stats(wqkv, wdw, dt)
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    lnw, lnb = f32(ln_w), f32(ln_b)
    n_parts = _stats_parts(code, b, h, w, c, cl, num_heads)
    dev = x.device
    part = torch.empty((b, n_parts, cl * dh + 2 * cl), dtype=torch.float32, device=dev)
    gram = torch.empty((b, cl, dh), dtype=torch.float32, device=dev)
    nq = torch.empty((b, num_heads, dh), dtype=torch.float32, device=dev)
    nk = torch.empty_like(nq)
    p = _build.ptr
    args = (x.data_ptr(), p(x2), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(), part.data_ptr(),
            gram.data_ptr(), nq.data_ptr(), nk.data_ptr(), p(rows), code, b, h, w, c1, c2, cl,
            num_heads, shift, eps, n_parts, flags, stream_ptr())
    return args, (gram, nq, nk), (x, x2, lnw, lnb, wq, wd, part, rows)


def _stats_launch(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps, halo=None):
    args, out, _held = _stats_prepare(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps, halo)
    _build.check("mp_spectral_stats", _stats_entry()(*args))
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    cl = wqkv.shape[0] // 3
    ln = ln_w is not None
    flags = 0 if halo is None else halo.flags
    STATS.record(("spectral_stats", b, h, w, c1, c2, num_heads, shift, ln, str(x.dtype)))
    if x.dtype == torch.float32:
        F32_TILE.record(("spectral_stats_f32", b, h, w, c1, c2, num_heads, shift, ln))
    if flags:
        STATS_HALO.record(("spectral_stats_halo", b, h, w, c1, c2, num_heads, ln, flags,
                           str(x.dtype)))
    if cl != c1 + c2:
        STATS_TP.record(("spectral_stats_tp", b, h, w, c1 + c2, cl, num_heads, flags,
                         str(x.dtype)))
    return out


def _stats_bwd_tc_launch(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk,
                         halo=None, rows=None, flags=0):
    """The bf16 backward: the two tiles, the weight product and one in-order
    sum of the per-tile partials (the taps' [9][2CL], then d ln_w, d ln_b;
    CL = wqkv.shape[0] / 3, C or a member's head block: t, dqk and dtt 2CL
    wide, the weight cotangents (3CL, C) and (3CL, 9), un and dx C wide).
    A row shard (``rows``, ``flags`` of :func:`_halo_operand`): tile 1 also
    writes the halo rows' LN'd input and 1x1 output, ``mp_dwconv_halo_bwd``
    their cotangents and tap partials, and :func:`_halo_rows_bwd` carries
    them to d halo.top / d halo.bot (None at an image edge)."""
    b, h, w, c = x.shape
    cl = wqkv.shape[0] // 3
    dt = x.dtype
    if c > FRONT_MAX_C:  # the widest C of both tiles' plans
        raise ValueError(f"the bf16 spectral stats backward takes C up to {FRONT_MAX_C}, got {c}")
    what = f"C={c}, heads={num_heads}" + ("" if cl == c else f", CL={cl}")
    _build.check_plan("spectral_stats_bwd", "mp_spectral_stats_bwd_tc_smem", what, c, cl,
                      num_heads)
    _build.check_plan("spectral_stats_bwd", "mp_dwconv_dx_tc_smem", what, c, 2 * cl)
    x = x.contiguous()
    wq, wd = pack_stats(wqkv, wdw, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dgram, dnq, dnk = f32(dgram), f32(dnq), f32(dnk)
    dev = x.device
    tiles = b * (h // 8) * (w // 8)
    k = 2 * cl
    un = torch.empty((b, h, w, c), dtype=dt, device=dev)
    t = torch.empty((b, h, w, k), dtype=dt, device=dev)
    dqk = torch.empty((b, h, w, k), dtype=torch.float32, device=dev)
    dtt, dx = torch.empty_like(t), torch.empty_like(x)
    ln = lnw is not None
    part = torch.empty((1, tiles, 9 * k + (2 * c if ln else 0)), dtype=torch.float32, device=dev)
    # the halo rows' LN'd input and 1x1 output (a side without its bit stays zero)
    un_h = torch.zeros((2, b, w, c), dtype=dt, device=dev) if flags else None
    t_h = torch.zeros((2, b, w, k), dtype=dt, device=dev) if flags else None
    p = _build.ptr
    err = _stats_entry("bwd_tc")(x.data_ptr(), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(),
                                 dgram.data_ptr(), dnq.data_ptr(), dnk.data_ptr(), un.data_ptr(),
                                 t.data_ptr(), dqk.data_ptr(), p(rows), p(un_h), p(t_h), b, h, w, c,
                                 cl, num_heads, shift, eps, flags, stream_ptr())
    _build.check("mp_spectral_stats_bwd_tc", err)
    err = _stats_entry("dx_tc")(dqk.data_ptr(), t.data_ptr(), wd.data_ptr(), wq.data_ptr(),
                                x.data_ptr(), p(lnw), dtt.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), b, h, w, c, k, shift, eps, stream_ptr())
    _build.check("mp_dwconv_dx_tc", err)
    dw = torch.zeros((3 * cl, c), dtype=torch.float32, device=dev)
    dw[:k] = wgrad(un.reshape(-1, c), dtt.reshape(-1, k)).t()
    sums = sum_parts(part)[0]
    dwdw = torch.zeros((3 * cl, 9), dtype=torch.float32, device=dev)
    dwdw[:k] = sums[:9 * k].reshape(9, k).t()
    dln = (sums[9 * k:9 * k + c], sums[9 * k + c:]) if ln else None
    dtop = dbot = None
    if flags:
        dtop, dbot, dln = _halo_taps_bwd(dqk, t_h, wd, wqkv, 0, rows, ln_w, eps, halo, un_h,
                                         dw[:k], dwdw[:k], dln)
        STATS_BWD_HALO.record(("spectral_stats_bwd_halo", b, h, w, c, num_heads, ln, flags,
                               str(dt)))
    STATS_BWD.record(("spectral_stats_bwd", b, h, w, c, num_heads, shift, ln, str(dt)))
    if cl != c:
        STATS_BWD_TP.record(("spectral_stats_bwd_tp", b, h, w, c, cl, num_heads, flags, str(dt)))
    return (dx, dw.reshape(3 * cl, c, 1, 1), dwdw.reshape(3 * cl, 1, 3, 3),
            *(dln if ln else (None, None)), dtop, dbot)


def _halo_rows_bwd(dt_halo, wk, col0, rows, ln_w, eps, halo, un_halo, dw):
    """The halo rows' share of a backward on the card: their input
    cotangents, from the cotangents ``dt_halo`` [2][B][W][K] of their 1x1
    output (:func:`~mp_hsir_tpu_torch.ops.kernels._grad.dwconv_halo_bwd`, in
    the compute type)
    through grad.cu's float32 1x1 + LayerNorm backward (``wk`` the float32
    [C][ldw] operand: bf16 weights widen exactly) on the raw rows ``rows``
    [2][B][W][C], rounded to the rows' type as the plain version rounds;
    the 2B rows are packed as whole 8-row tiles of zeros beyond them, which
    add nothing. Adds their 1x1 weight gradient (``un_halo`` [2][B][W][C]
    their LN'd input, ``dt_halo``'s type) into ``dw`` [K][C]; returns (d top,
    d bot (None at an image edge), (d ln_w, d ln_b) or None)."""
    _, b, w, k = dt_halo.shape
    c = rows.shape[-1]
    n = 2 * b
    g = -(-n // 8)
    f32 = dict(dtype=torch.float32, device=rows.device)
    d = torch.zeros((g * 8, w, k), **f32)
    d[:n] = dt_halo.reshape(n, w, k)
    xr = torch.zeros((g * 8, w, c), **f32)
    xr[:n] = rows.reshape(n, w, c)
    dx, dln, _ = ln_linear_bwd(d.reshape(g, 8, w, k), wk, col0, xr.reshape(g, 8, w, c), ln_w,
                               eps=eps)
    dx = dx.reshape(g * 8, w, c)[:n].reshape(2, b, 1, w, c).to(rows.dtype)
    dw += wgrad(un_halo.reshape(-1, c), dt_halo.reshape(-1, k)).t()
    return None if halo.edge_top else dx[0], None if halo.edge_bot else dx[1], dln


def _taps(wdw, col0: int, k: int) -> torch.Tensor:
    """The float32 depthwise taps [K][9] of channels [col0, col0 + k)."""
    return wdw.reshape(-1, 9)[col0:col0 + k].float().contiguous()


def _halo_taps_bwd(dout, t_h, taps, wqkv, col0, rows, ln_w, eps, halo, un_h, dw, dwdw, dln):
    """The halo rows' share of a backward on the card, after its stencil:
    ``mp_dwconv_halo_bwd`` on the cotangent ``dout`` at the depthwise output
    and the halo rows' 1x1 output ``t_h`` (taps [K][9], both in the compute
    type) adds their tap partials into ``dwdw`` [K][9] (the taps' first row
    from the row above, the last from the row below), then
    :func:`_halo_rows_bwd` their input cotangents, their 1x1 weight gradient
    into ``dw`` [K][C] and their LayerNorm share into ``dln``. Returns (d
    top, d bot, dln)."""
    dt_h, dw_h = dwconv_halo_bwd(dout, t_h, taps, halo.flags)
    dwdw[:, :3] += dw_h[0].t()
    dwdw[:, 6:] += dw_h[1].t()
    wk = kernel_weight(wqkv.to(t_h.dtype), torch.float32)
    dtop, dbot, dln_h = _halo_rows_bwd(dt_h, wk, col0, rows, ln_w, eps, halo, un_h, dw)
    return dtop, dbot, _add_ln(dln, dln_h)


def _add_ln(dln, extra):
    """(d ln_w, d ln_b) of the shard's pixels plus its halo rows' share."""
    if dln is None:
        return None, None
    return tuple(a + e for a, e in zip(dln, extra)) if extra is not None else dln


def _stats_bwd_launch(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk,
                      halo=None):
    """The backward on the card. Both types take a member's head block (CL
    = wqkv.shape[0] / 3 < C): t and dqk are 2CL wide, the weight cotangents
    (3CL, C) and (3CL, 9), dx and the halo rows' cotangents C wide."""
    rows, flags = _halo_operand(halo, x, None, shift)
    b, h, w, c = x.shape
    cl = wqkv.shape[0] // 3
    if x.dtype == torch.bfloat16:
        return _stats_bwd_tc_launch(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq,
                                    dnk, halo, rows, flags)
    dt = x.dtype
    _build.check_plan("spectral_stats_bwd", "mp_spectral_stats_bwd_smem",
                      f"C={c}, CL={cl}, heads={num_heads}", c, cl, num_heads)
    x = x.contiguous()
    wq, wd = kernel_weight(wqkv, dt), kernel_weight(wdw, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dgram, dnq, dnk = f32(dgram), f32(dnq), f32(dnk)
    dev = x.device
    un = torch.empty((b, h, w, c), dtype=dt, device=dev)
    t = torch.empty((b, h, w, 2 * cl), dtype=torch.float32, device=dev)
    dqk = torch.empty_like(t)
    # the halo rows' LN'd input and 1x1 output (a side without its bit stays zero)
    un_h = torch.zeros((2, b, w, c), dtype=torch.float32, device=dev) if flags else None
    t_h = torch.zeros((2, b, w, 2 * cl), dtype=torch.float32, device=dev) if flags else None
    p = _build.ptr
    err = _stats_entry("bwd")(x.data_ptr(), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(),
                             dgram.data_ptr(), dnq.data_ptr(), dnk.data_ptr(), un.data_ptr(),
                             t.data_ptr(), dqk.data_ptr(), p(rows), p(un_h), p(t_h), b, h, w, c,
                             cl, num_heads, shift, eps, flags, stream_ptr())
    _build.check("mp_spectral_stats_bwd", err)
    dtt, dwdw_qk = dwconv_bwd(dqk, t, wd, 0, dt)
    dx, dln, _ = ln_linear_bwd(dtt, wq, 0, x, ln_w, shift=-shift, eps=eps)
    dw = torch.zeros((3 * cl, c), dtype=torch.float32, device=dev)
    dw[:2 * cl] = wgrad(un.reshape(-1, c), dtt.reshape(-1, 2 * cl)).t()
    dwdw = torch.zeros((3 * cl, 9), dtype=torch.float32, device=dev)
    dwdw[:2 * cl] = dwdw_qk.t()
    dtop = dbot = None
    if flags:
        dtop, dbot, dln = _halo_taps_bwd(dqk, t_h, _taps(wdw, 0, 2 * cl), wqkv, 0, rows, ln_w,
                                         eps, halo, un_h, dw[:2 * cl], dwdw[:2 * cl], dln)
        STATS_BWD_HALO.record(("spectral_stats_bwd_halo", b, h, w, c, num_heads,
                               ln_w is not None, flags, str(dt)))
    STATS_BWD.record(("spectral_stats_bwd", b, h, w, c, num_heads, shift, ln_w is not None, str(dt)))
    if cl != c:
        STATS_BWD_TP.record(("spectral_stats_bwd_tp", b, h, w, c, cl, num_heads, flags, str(dt)))
    return (dx, dw.reshape(3 * cl, c, 1, 1), dwdw.reshape(3 * cl, 1, 3, 3),
            *(dln if dln is not None else (None, None)), dtop, dbot)


def _halo_in(htop, hbot, edges):
    """The :class:`Halo` an autograd Function was given as tensors and flags."""
    return None if htop is None else Halo(htop, hbot, *edges)


def _halo_args(halo):
    """A :class:`Halo` as the Functions take it: its two rows as tensor
    inputs (autograd routes their cotangents back through the collective
    that brought them) and the edge flags."""
    return (None, None, None) if halo is None else (halo.top, halo.bot,
                                                    (halo.edge_top, halo.edge_bot))


class _SpectralStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wdw, x2, ln_w, ln_b, htop, hbot, cfg):
        num_heads, shift, eps, edges = cfg
        halo = _halo_in(htop, hbot, edges)
        ctx.kernel = ROUTE.use_kernel(x)
        fn = _stats_launch if ctx.kernel else spectral_stats_plain
        out = fn(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps, halo)
        ctx.cfg = cfg
        ctx.has_x2 = x2 is not None
        ctx.save_for_backward(x, wqkv, wdw, ln_w, ln_b, htop, hbot)
        return out

    @staticmethod
    def backward(ctx, dgram, dnq, dnk):
        x, wqkv, wdw, ln_w, ln_b, htop, hbot = ctx.saved_tensors
        num_heads, shift, eps, edges = ctx.cfg
        _no_eval_only_grad("spectral_stats", x2=True if ctx.has_x2 else None)
        b, cl = x.shape[0], wqkv.shape[0] // 3
        z = x.new_zeros((b, cl, cl // num_heads), dtype=torch.float32)
        dgram = grad_or_zeros(dgram, z)
        dnq = grad_or_zeros(dnq, z[:, :num_heads])
        dnk = grad_or_zeros(dnk, z[:, :num_heads])
        if ctx.kernel:
            fn = _stats_bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = spectral_stats_bwd_plain
        dx, dw, dwdw, dlnw, dlnb, dtop, dbot = fn(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps,
                                                  dgram, dnq, dnk, _halo_in(htop, hbot, edges))
        return dx, dw, dwdw, None, dlnw, dlnb, dtop, dbot, None


def spectral_stats(x, wqkv, wdw, num_heads: int, shift: int = 0, x2=None, ln_w=None,
                   ln_b=None, eps: float = 1e-5, halo: Halo | None = None):
    """Same contract as :func:`spectral_stats_plain`, differentiable without
    x2 (the halo rows too: their cotangents go back to ``halo.top`` /
    ``halo.bot``); launches the CUDA kernels (forward: a per-part pass, bf16
    on the tensor-core tile, then an in-order sum of the parts; backward: bf16
    the two tiles, float32 ``mp_spectral_stats_bwd`` and grad.cu's stages) on
    a CUDA tensor, with real halo rows in both types."""
    htop, hbot, edges = _halo_args(halo)
    return _SpectralStats.apply(x, wqkv, wdw, x2, ln_w, ln_b, htop, hbot,
                                (num_heads, shift, eps, edges))


def spectral_fold(gram, nq, nk, temperature, wout) -> torch.Tensor:
    """comb (B, CL, C) float32, row = v channel (h, e), col = output channel:
    comb[h*dh+e, o] = sum_d softmax_e(G[d, e] / (|q_d| |k_e|) * t_h) W[(h, d), o].
    gram (B, CL, dh); wout (C, CL, 1, 1): the projection's input columns of
    these heads (CL = C, or a member's head block under the spectral mesh
    axis)."""
    b, cl, dh = gram.shape
    nh = cl // dh
    nqs = nq.sqrt().clamp_min(1e-12)
    nks = nk.sqrt().clamp_min(1e-12)
    attn = gram.reshape(b, nh, dh, dh) / (nqs[..., :, None] * nks[..., None, :])
    attn = torch.softmax(attn * temperature.float().reshape(1, nh, 1, 1), dim=-1)
    co = wout.shape[0]
    wr = wout.float().reshape(co, cl).t().reshape(nh, dh, co)  # [(h, d)][o]
    return torch.einsum("bhde,hdo->bheo", attn, wr).reshape(b, cl, co).contiguous()


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _gate_win(gate, h: int):
    """The gate's window over a map of h rows: 8 for per-window gates (B,
    H/8, W/8, C), 1 for a per-pixel gate map (B, H, W, C); 0 without."""
    if gate is None:
        return 0
    if gate.shape[1] not in (h, h // 8):
        raise ValueError(f"a gate has H/8 or H rows, got {tuple(gate.shape)} over {h}")
    return 1 if gate.shape[1] == h else 8


def _gate_kind(gate, h: int):
    """The gate's field of a launch record: True (per-window gates), "map"
    (a per-pixel gate map) or False."""
    return {0: False, 8: True, 1: "map"}[_gate_win(gate, h)]


def _gate_map(gate, shift, h: int):
    """The gates over a map of h rows (per-window, of the rolled frame; or
    already a per-pixel map of it) as a per-pixel map of the unrolled
    frame."""
    gmap = gate
    if _gate_win(gate, h) == 8:
        gmap = gate.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)
    return roll_hw(gmap, shift, shift) if shift else gmap


def spectral_apply_plain(x, comb, wqkv, wdw, shift: int = 0, x2=None, ln_w=None, ln_b=None,
                         residual: bool = False, gate=None, shortcut=None, mlp=None,
                         eps: float = 1e-5, dp_scale=None, halo: Halo | None = None):
    """out = v @ comb [+ x * gate] [+ x] [+ shortcut], then optionally the
    PGSSTB tail ``out + fc2(a * gelu(g))``, ``[a|g] = fc1(LN2(out))``;
    ``mlp = (ln2_w, ln2_b, fc1_w (2h, C), fc1_b, fc2_w (C, h), fc2_b)``.
    ``gate`` (B, H/8, W/8, C) holds the per-window gates of the rolled frame,
    or (B, H, W, C) a per-pixel gate map (a row shard's, JAX's ``gate_map``).
    ``dp_scale`` (B,): per-sample drop-path scale of the branch
    ``v @ comb [+ x * gate]``, summed in float32 and rounded once.
    ``halo``: x is a row shard (:class:`Halo`). Under the spectral mesh axis
    wqkv holds a member's head block (CL = wqkv.shape[0] / 3 q/k/v rows,
    ``parallel/tp.py``), comb is (B, CL, C) and out its partial projection
    plus the epilogue. Output (B, H, W, C) in the unrolled frame."""
    dt = x.dtype
    raw, u, rows = _input(x, x2, shift, ln_w, ln_b, eps, halo)
    b, h, w, c = u.shape
    cl = wqkv.shape[0] // 3
    v = _qkv_part(u, wqkv, wdw, 2 * cl, 3 * cl, dt, rows)[1]
    y = torch.einsum("bhwc,bco->bhwo", v, comb.to(dt).float())
    gu = None if gate is None else raw.float() * _gate_map(gate, shift, h).float()
    if dp_scale is not None:
        y = ((y if gu is None else y + gu) * dp_scale.float().reshape(b, 1, 1, 1)).to(dt)
    else:
        y = y.to(dt)
        if gu is not None:
            y = (gu.to(dt).float() + y.float()).to(dt)
    if residual:
        y = (raw.float() + y.float()).to(dt)
    if shortcut is not None:
        y = (shortcut.float() + y.float()).to(dt)
    if mlp is not None:
        ln2_w, ln2_b, w1, b1, w2, b2 = mlp
        hid = w2.shape[1]
        hmid = layer_norm(y, ln2_w, ln2_b, eps).float() @ w1.to(dt).float().t() + b1.float()
        gated = (hmid[..., :hid] * gelu_exact(hmid[..., hid:])).to(dt)
        y = (y.float() + gated.float() @ w2.to(dt).float().t() + b2.float()).to(dt)
    return y


def spectral_apply_bwd_plain(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale,
                             eps, dy, halo: Halo | None = None):
    """Explicit VJP of :func:`spectral_apply_plain` without x2 / mlp: returns
    (dx, d comb, d wqkv, d wdw, d ln_w, d ln_b, d gate, d shortcut, d dp,
    d halo.top, d halo.bot); the q/k sections of the weight cotangents are
    zero, a halo row's cotangent None at an image edge (and without
    ``halo``)."""
    dt = x.dtype
    raw, u, rows = _input(x, None, shift, ln_w, ln_b, eps, halo)
    b, h, w, c = u.shape
    cl = wqkv.shape[0] // 3
    v = _qkv_part(u, wqkv, wdw, 2 * cl, 3 * cl, dt, rows)[1]
    dyf = dy.float()
    dys = dyf if dp_scale is None else (dyf * dp_scale.float().reshape(b, 1, 1, 1)).to(dt).float()
    cr = comb.to(dt).float()
    dcomb = torch.einsum("byxk,byxo->bko", v, dys)
    dv = torch.einsum("byxo,bko->byxk", dys, cr)
    extra = torch.zeros_like(dyf)
    dgate = ddp = gu = None
    if gate is not None:
        gmap = _gate_map(gate, shift, h).float()
        gu = raw.float() * gmap
        extra = extra + dys * gmap
        prod = dys * raw.float()
        prod = roll_hw(prod, -shift, -shift) if shift else prod
        if _gate_win(gate, h) == 8:
            prod = prod.reshape(b, h // 8, 8, w // 8, 8, c).sum(dim=(2, 4))
        dgate = prod.to(gate.dtype)
    if residual:
        extra = extra + dyf
    if dp_scale is not None:
        br = torch.einsum("byxk,bko->byxo", v, cr)
        br = br if gu is None else br + gu
        ddp = (dyf * br).sum(dim=(1, 2, 3)).to(dp_scale.dtype)
    du, dw_v, dwdw_v, dlnw, dlnb, dtop, dbot = _qkv_bwd(raw, u, rows, halo, wqkv, wdw, 2 * cl,
                                                        3 * cl, dt, dv, ln_w, eps)
    dw = torch.zeros((3 * cl, c), dtype=torch.float32, device=x.device)
    dw[2 * cl:] = dw_v
    dwdw = torch.zeros((3 * cl, 1, 3, 3), dtype=torch.float32, device=x.device)
    dwdw[2 * cl:] = dwdw_v
    du = du + extra
    dx = roll_hw(du, -shift, -shift) if shift else du
    return (dx.to(dt), dcomb, dw.reshape(3 * cl, c, 1, 1), dwdw, dlnw, dlnb, dgate, dy, ddp,
            dtop, dbot)


def front_plan(c: int, cl: int | None = None) -> dict:
    """The bf16 apply tile's tiling at input width ``c`` and v width ``cl``
    (default ``c``; a member's head block under the spectral mesh axis)
    (``FrontPlan`` in csrc/spectral_front.cuh): ``cp`` / ``cpl`` = c / cl
    rounded up to 32, the 1x1 product's output passes of ``np`` columns
    (over cpl), ``nk`` 64-deep weight tiles per pass (over cp), ``nkc``
    64-deep comb tiles (over cpl), ``ws`` weight ring stages; ``ldv`` the v
    tile's row; ``front_bytes`` the front's dynamic bytes (taps | v | halo
    | ring, without the tail)."""
    cl = c if cl is None else cl
    cp, cpl = -(-c // 32) * 32, -(-cl // 32) * 32
    nb = cpl // 32
    passes = -(-7 * nb // (16 * FRONT_UNITS))
    np_ = 32 * -(-nb // passes)
    ws = 2 if passes > 1 or cp > 192 else 3
    ld, ldv = cp + 8, cpl + 8
    ring = max(ws * 2 * np_ * FRONT_LDW, 2 * 100 * (np_ + 8), 2 * 2 * 64 * ld - 2 * FRONT_ROWS * ld)
    front = 2 * 9 * cpl + 2 * 64 * ldv + 2 * FRONT_ROWS * ld + ring
    return dict(cp=cp, cpl=cpl, passes=passes, np=np_, nk=-(-cp // FRONT_K),
                nkc=-(-cpl // FRONT_K), ws=ws, ldv=ldv, front_bytes=front)


def pack_front(wqkv, wdw, comb, dt):
    """The operands the bf16 apply tile streams, in ``dt``: the v rows of
    the 1x1 weight as [CL out][C8 in] (torch layout; CL = wqkv.shape[0] / 3,
    C or a member's head block), their depthwise taps as [CL][9], and
    ``comb`` (B, CL, C) as (B, CL, C8); C8 is C rounded up to 8, the rows
    padded with zeros only where C is not a multiple of 8 (16-byte rows for
    the kernel's copies). Views of the weights where they are already in
    ``dt``; the kernel stages [np][64] tiles of the first and [64][cp] tiles
    of the last (:func:`front_plan`), zero past CL rows and C columns."""
    c, cl = wqkv.shape[1], wqkv.shape[0] // 3
    wv, cb = wqkv[2 * cl:].reshape(cl, c).to(dt), comb.to(dt)
    if c % 8:
        wv, cb = F.pad(wv, (0, -c % 8)), F.pad(cb, (0, -c % 8))
    return wv.contiguous(), wdw[2 * cl:].reshape(cl, 9).to(dt).contiguous(), cb.contiguous()


def apply_f32_plan(c: int, tail: bool = False, cl: int | None = None) -> dict:
    """The float32 apply tile's tiling at input width ``c`` and v width
    ``cl`` (default ``c``; a member's head block under the spectral mesh
    axis, which takes no tail) (``ApplyF32Plan`` in
    csrc/spectral_front_f32.cuh): ``cp`` / ``cpl`` = c / cl rounded up to
    32; the v channels' 1x1 in ``groups`` column groups of ``gw`` (at most
    192), each streaming the halo's and the group's v rows' ``nk`` chunks of
    :data:`F32_K` input channels through ``ws`` ring stages; comb's product
    in ``passes`` passes of ``np`` output channels (at most 384), each
    streaming comb^T's ``nkv`` chunks (cl deep) through ``cs`` stages;
    ``ldv`` the v tile's row. ``front`` the front's dynamic bytes, ``dyn``
    the launch's (with the tail, the larger of the front and the tail's
    scratch, :func:`~mp_hsir_tpu_torch.ops.kernels.mlp.tail_f32_plan`),
    ``bytes`` with the static (what ``mp_spectral_apply_smem(c, cl, tail,
    0)`` returns)."""
    cl = c if cl is None else cl
    cp, cpl = -(-c // 32) * 32, -(-cl // 32) * 32
    nb, nbl = cp // 32, cpl // 32
    groups = -(-nbl // (APPLY_F32_MAX_GW // 32))
    gw = 32 * -(-nbl // groups)
    passes = -(-nb // (COMB_MAX_N // 32))
    np_ = 32 * -(-nb // passes)
    ldv = cpl + 4
    fixed = 4 * (9 * cpl + 2 * FRONT_ROWS + 64 * ldv)
    stage, cstage = 4 * (FRONT_ROWS + gw) * F32_LD, 4 * np_ * F32_LD
    room = max(APPLY_F32_BUDGET - fixed, 0)
    ws, cs = (3 if room // n >= 3 else 2 for n in (stage, cstage))
    front = fixed + max(ws * stage, 4 * 100 * (gw + 8), cs * cstage)
    dyn = max(front, tail_f32_plan(c)["bytes"]) if tail else front
    return dict(cp=cp, cpl=cpl, nk=cp // F32_K, nkv=cpl // F32_K, groups=groups, gw=gw,
                passes=passes, np=np_, ldv=ldv, ws=ws, cs=cs, front=front, dyn=dyn,
                bytes=dyn + APPLY_F32_STATIC)


def pack_front_f32(wqkv, wdw, comb):
    """The operands the float32 apply tile streams: the v rows of the 1x1
    weight as [CL out][C8 in] (CL = wqkv.shape[0] / 3: C, or a member's head
    block) and their taps [CL][9] in float32, and ``comb`` (B, CL, C)
    transposed, (B, C out, CL8 in) (the rows of the comb product's B
    operand); C8 / CL8 are C / CL rounded up to 8 (16-byte rows, padded with
    zeros only where needed). Views of the weights where they are float32
    already; at CL = C :func:`pack_front`'s operands."""
    c, cl = wqkv.shape[1], wqkv.shape[0] // 3
    wv = wqkv[2 * cl:].reshape(cl, c).float()
    cb = comb.float().transpose(1, 2)
    if c % 8:
        wv = F.pad(wv, (0, -c % 8))
    if cl % 8:
        cb = F.pad(cb, (0, -cl % 8))
    return wv.contiguous(), wdw[2 * cl:].reshape(cl, 9).float().contiguous(), cb.contiguous()


def apply_bwd_tc_plan(c: int, cl: int | None = None) -> dict:
    """The bf16 apply backward's plans at input width ``c`` and v width
    ``cl`` (default ``c``): the first tile's (``ApplyBwdPlan`` in
    csrc/spectral_apply_bwd.cuh: :func:`front_plan`'s tiling; ``front`` = v
    [64][ldv] | taps [9][cpl] | halo [112][ld] | the weight ring of ``ws``
    stages or a pass's 1x1 output, whichever is larger; after the front
    ``post`` = v | dys [64][ld] | ``cs`` comb stages of [64][ld], 3 where
    they fit at CL = C; ``bytes`` the larger) and the second tile's at K = CL (``dx``:
    :func:`dwconv_dx_plan`)."""
    cl = c if cl is None else cl
    pl = front_plan(c, cl)
    ld = pl["cp"] + 8
    v, ds = 2 * 64 * pl["ldv"], 2 * 64 * ld
    ring = max(pl["ws"] * 2 * pl["np"] * FRONT_LDW, 2 * 100 * (pl["np"] + 8))
    front = v + 2 * 9 * pl["cpl"] + 2 * FRONT_ROWS * ld + ring
    cs = 3 if 5 * ds <= STATS_BUDGET else 2  # as at CL = C: the plan never outgrows it
    post = v + ds + cs * ds
    return dict(pl, ld=ld, cs=cs, front=front, post=post, bytes=max(front, post),
                dx=dwconv_dx_plan(c, cl))


@lru_cache(maxsize=None)
def _apply_entry(kind: str = "fwd"):
    import ctypes

    if kind == "bwd":
        return _build.entry("mp_spectral_apply_bwd", 20,
                            [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
    if kind == "bwd_tc":
        return _build.entry("mp_spectral_apply_bwd_tc", 19,
                            [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
    if kind == "dx_tc":
        return _build.entry("mp_spectral_apply_dx_tc", 10, [ctypes.c_int] * 7 + [ctypes.c_float])
    if kind == "gate":
        return _build.entry("mp_spectral_gate_grad", 3, [ctypes.c_int] * 6)
    return _build.entry("mp_spectral_apply", 18,
                        [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])


def _apply_prepare(x, comb, wqkv, wdw, shift=0, x2=None, ln_w=None, ln_b=None, residual=False,
                   gate=None, shortcut=None, mlp=None, eps=1e-5, dp_scale=None, halo=None):
    """Everything a launch needs: (the C entry's arguments, out, the tensors
    the arguments point into, to be held until the launch). Weights: bf16
    :func:`pack_front`, float32 :func:`pack_front_f32` (a member's head
    block in both: CL = wqkv.shape[0] / 3 < C v rows, comb (B, CL, C), no tail); the
    tail's :func:`pack_mlp_weights` in the compute type; ``halo``: the rows
    of :func:`_halo_operand`."""
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    c = c1 + c2
    cl = wqkv.shape[0] // 3
    if h % 8 or w % 8:
        raise ValueError(f"spectral apply needs H, W % 8 == 0, got {x.shape}")
    if (gate is not None or dp_scale is not None) and (x2 is not None or ln_w is not None):
        raise ValueError("the gate and drop-path epilogues take one raw input")
    if wqkv.shape[1] != c or cl > c or comb.shape[1:] != (cl, c):
        raise ValueError(f"spectral apply takes a (3CL, C) weight with CL <= C and comb (B, CL, "
                         f"C), got {tuple(wqkv.shape)} and {tuple(comb.shape)} at C = {c}")
    if cl != c and mlp is not None:
        raise ValueError("a head block's apply takes no MLP tail (the tail follows the sum "
                         "over the spectral mesh axis)")
    dt, code = x.dtype, dtype_code(x)
    tail = int(mlp is not None)
    if code and c > FRONT_MAX_C:  # the front's and the tail tile's widest C
        raise ValueError(f"the bf16 spectral apply kernel takes C up to {FRONT_MAX_C}, got {c}")
    _build.check_plan("spectral_apply", "mp_spectral_apply_smem",
                      f"C={c}, CL={cl}, {'with' if tail else 'no'} MLP tail", c, cl, tail, code)
    rows, flags = _halo_operand(halo, x, x2, shift)
    gwin = _gate_win(gate, h) or 8
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    gate = None if gate is None else gate.to(dt).contiguous()
    shortcut = None if shortcut is None else shortcut.to(dt).contiguous()
    wq, wd, cb = pack_front(wqkv, wdw, comb, dt) if code else pack_front_f32(wqkv, wdw, comb)
    lnw, lnb, dp = f32(ln_w), f32(ln_b), f32(dp_scale)
    hid = 0
    ln2w = ln2b = w1 = b1 = w2 = b2 = None
    if tail:
        ln2w, ln2b, b1, b2 = f32(mlp[0]), f32(mlp[1]), f32(mlp[3]), f32(mlp[5])
        w1, w2 = pack_mlp_weights(mlp[2], mlp[4], dt)
        hid = mlp[4].shape[1]
    out = torch.empty((b, h, w, c), dtype=dt, device=x.device)
    p = _build.ptr
    args = (x.data_ptr(), p(x2), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(), cb.data_ptr(),
            p(gate), p(shortcut), p(ln2w), p(ln2b), p(w1), p(b1), p(w2), p(b2), p(dp),
            out.data_ptr(), p(rows), code, b, h, w, c1, c2, cl, int(residual), hid, shift, eps,
            flags, gwin, stream_ptr())
    return args, out, (x, x2, gate, shortcut, wq, wd, lnw, lnb, cb, dp, ln2w, ln2b, w1, b1, w2, b2,
                       rows)


def _apply_launch(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate, shortcut, mlp, eps,
                  dp_scale, halo=None):
    args, out, _held = _apply_prepare(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate,
                                      shortcut, mlp, eps, dp_scale, halo)
    _build.check("mp_spectral_apply", _apply_entry()(*args))
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    hid = 0 if mlp is None else mlp[4].shape[1]
    dt = x.dtype
    spec = ("spectral_apply", b, h, w, c1, c2, shift, ln_w is not None, bool(residual),
            _gate_kind(gate, h), shortcut is not None, hid, str(dt))
    spec = spec if dp_scale is None else spec[:-1] + ("dp", str(dt))
    APPLY.record(spec)
    if dt == torch.float32:
        APPLY_F32.record(("spectral_apply_f32",) + spec[1:-1])
        if hid:
            TAIL_F32.record(("mlp_tail_f32", b, h, w, c1 + c2, hid))
    flags = 0 if halo is None else halo.flags
    if flags:
        APPLY_HALO.record(("spectral_apply_halo", b, h, w, c1, c2, flags, str(dt)))
    cl = wqkv.shape[0] // 3
    if cl != c1 + c2:
        APPLY_TP.record(("spectral_apply_tp", b, h, w, c1 + c2, cl, _gate_kind(gate, h),
                         dp_scale is not None, flags, str(dt)))
    return out


def _apply_bwd_tc_launch(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps,
                         dy, halo=None, rows=None, flags=0):
    """The bf16 backward: the two tiles, d gate, the two weight products and
    the in-order sums of the per-tile partial rows (the taps' [9][CL], then
    d ln_w, d ln_b, then d dp): per image over its tiles, then over the
    images (d dp per image from the first). CL = wqkv.shape[0] / 3 (C, or a
    member's head block): t, v, dv and dtt CL wide, d comb (B, CL, C), the
    weight cotangents (3CL, C) and (3CL, 9); dx, d gate and the halo rows'
    cotangents C wide. A row shard: the halo rows' share as
    :func:`_stats_bwd_tc_launch` adds it."""
    b, h, w, c = x.shape
    cl = wqkv.shape[0] // 3
    dt = x.dtype
    if c > FRONT_MAX_C:  # the widest C of both tiles' plans
        raise ValueError(f"the bf16 spectral apply backward takes C up to {FRONT_MAX_C}, got {c}")
    what = f"C={c}" + ("" if cl == c else f", CL={cl}")
    for tile in (1, 2):
        _build.check_plan("spectral_apply_bwd", "mp_spectral_apply_bwd_tc_smem",
                          f"{what}, tile {tile}", c, cl, tile)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    gwin = _gate_win(gate, h)
    gate_t = None if gate is None else gate.to(dt).contiguous()
    wv, wd, cb = pack_front(wqkv, wdw, comb, dt)
    lnw, lnb, dp = f32(ln_w), f32(ln_b), f32(dp_scale)
    dev = x.device
    tiles = b * (h // 8) * (w // 8)
    like = dict(dtype=dt, device=dev)
    un, dx = (torch.empty((b, h, w, c), **like) for _ in range(2))
    t, v, dtt = (torch.empty((b, h, w, cl), **like) for _ in range(3))
    dys = dy if dp is None else torch.empty_like(un)
    dv = torch.empty((b, h, w, cl), dtype=torch.float32, device=dev)
    extra = (torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
             if (gate is not None or residual) else None)
    ln = lnw is not None
    o_dp = 9 * cl + (2 * c if ln else 0)  # the part row: taps, [LN], [d dp]
    ldp = o_dp + int(dp is not None)
    part = torch.empty((b, tiles // b, ldp), dtype=torch.float32, device=dev)
    pdp = None if dp is None else part.data_ptr() + 4 * o_dp  # column o_dp of row 0
    # the halo rows' LN'd input and v 1x1 output (a side without its bit stays zero)
    un_h = torch.zeros((2, b, w, c), **like) if flags else None
    t_h = torch.zeros((2, b, w, cl), **like) if flags else None
    p = _build.ptr
    err = _apply_entry("bwd_tc")(x.data_ptr(), p(lnw), p(lnb), wv.data_ptr(), wd.data_ptr(),
                                 cb.data_ptr(), p(gate_t), p(dp), dy.data_ptr(), un.data_ptr(),
                                 t.data_ptr(), v.data_ptr(), None if dp is None else dys.data_ptr(),
                                 dv.data_ptr(), p(extra), pdp, p(rows), p(un_h), p(t_h), b, h, w,
                                 c, cl, int(residual), shift, ldp, eps, flags, gwin or 8,
                                 stream_ptr())
    _build.check("mp_spectral_apply_bwd_tc", err)
    dgate = None
    if gate is not None:
        dgate = torch.empty((b, h // gwin, w // gwin, c), dtype=torch.float32, device=dev)
        err = _apply_entry("gate")(dys.data_ptr(), x.data_ptr(), dgate.data_ptr(), b, h, w, c,
                                   shift, gwin, stream_ptr())
        _build.check("mp_spectral_gate_grad", err)
    err = _apply_entry("dx_tc")(dv.data_ptr(), t.data_ptr(), wd.data_ptr(), wv.data_ptr(),
                                x.data_ptr(), p(lnw), p(extra), dtt.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), b, h, w, c, cl, shift, ldp, eps, stream_ptr())
    _build.check("mp_spectral_apply_dx_tc", err)
    dw = torch.zeros((3 * cl, c), dtype=torch.float32, device=dev)
    dw[2 * cl:] = wgrad(un.reshape(-1, c), dtt.reshape(-1, cl)).t()
    dcomb = wgrad(v.reshape(b, h * w, cl), dys.reshape(b, h * w, c))
    per_image = sum_parts(part)
    sums = sum_parts(per_image.unsqueeze(0))[0]
    dwdw = torch.zeros((3 * cl, 9), dtype=torch.float32, device=dev)
    dwdw[2 * cl:] = sums[:9 * cl].reshape(9, cl).t()
    dln = (sums[9 * cl:9 * cl + c], sums[9 * cl + c:9 * cl + 2 * c]) if ln else None
    dtop = dbot = None
    if flags:
        dtop, dbot, dln = _halo_taps_bwd(dv, t_h, wd, wqkv, 2 * cl, rows, ln_w, eps, halo, un_h,
                                         dw[2 * cl:], dwdw[2 * cl:], dln)
        APPLY_BWD_HALO.record(("spectral_apply_bwd_halo", b, h, w, c, ln, bool(residual),
                               _gate_kind(gate, h), dp is not None, flags, str(dt)))
    APPLY_BWD.record(("spectral_apply_bwd", b, h, w, c, shift, ln, bool(residual),
                      _gate_kind(gate, h), dp is not None, str(dt)))
    if cl != c:
        APPLY_BWD_TP.record(("spectral_apply_bwd_tp", b, h, w, c, cl, _gate_kind(gate, h),
                             dp is not None, flags, str(dt)))
    return (dx, dcomb, dw.reshape(3 * cl, c, 1, 1), dwdw.reshape(3 * cl, 1, 3, 3),
            *(dln if ln else (None, None)), None if dgate is None else dgate.to(gate.dtype), dy,
            None if dp is None else per_image[:, o_dp].to(dp_scale.dtype), dtop, dbot)


def _apply_bwd_launch(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps, dy,
                      halo=None):
    """The backward on the card. Both types take a member's head block (CL =
    wqkv.shape[0] / 3 < C): t, v and dv are CL wide, d comb (B, CL, C), the
    weight cotangents (3CL, C) and (3CL, 9); dx, d gate and the halo rows'
    cotangents C wide."""
    rows, flags = _halo_operand(halo, x, None, shift)
    b, h, w, c = x.shape
    cl = wqkv.shape[0] // 3
    if x.dtype == torch.bfloat16:
        return _apply_bwd_tc_launch(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate,
                                    dp_scale, eps, dy, halo, rows, flags)
    dt = x.dtype
    kc = _build.chunk("mp_spectral_apply_bwd_chunk", c, cl)
    _build.check_plan("spectral_apply_bwd", "mp_spectral_apply_bwd_smem", f"C={c}, CL={cl}",
                      c, cl, kc)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    gwin = _gate_win(gate, h)
    gate_t = None if gate is None else gate.to(dt).contiguous()
    wq, wd = kernel_weight(wqkv, dt), kernel_weight(wdw, dt)
    lnw, lnb, cb, dp = f32(ln_w), f32(ln_b), f32(comb), f32(dp_scale)
    dev = x.device
    tiles = (h // 8) * (w // 8)
    like = dict(dtype=dt, device=dev)
    un, dys = (torch.empty((b, h, w, c), **like) for _ in range(2))
    v = torch.empty((b, h, w, cl), **like)
    t = torch.empty((b, h, w, cl), dtype=torch.float32, device=dev)
    dv = torch.empty_like(t)
    extra = (torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
             if (gate is not None or residual) else None)
    pdp = torch.empty((b, tiles), dtype=torch.float32, device=dev) if dp is not None else None
    dgate = (torch.empty((b, h // gwin, w // gwin, c), dtype=torch.float32, device=dev)
             if gate is not None else None)
    # the halo rows' LN'd input and v 1x1 output (a side without its bit stays zero)
    un_h = torch.zeros((2, b, w, c), dtype=torch.float32, device=dev) if flags else None
    t_h = torch.zeros((2, b, w, cl), dtype=torch.float32, device=dev) if flags else None
    p = _build.ptr
    err = _apply_entry("bwd")(x.data_ptr(), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(),
                              cb.data_ptr(), p(gate_t), p(dp), dy.data_ptr(), un.data_ptr(),
                              t.data_ptr(), v.data_ptr(), dys.data_ptr(), dv.data_ptr(), p(extra),
                              p(pdp), p(dgate), p(rows), p(un_h), p(t_h), dtype_code(x), b, h, w,
                              c, cl, int(residual), shift, kc, eps, flags, gwin or 8, stream_ptr())
    _build.check("mp_spectral_apply_bwd", err)
    dtt, dwdw_v = dwconv_bwd(dv, t, wd, 2 * cl, dt)
    dx, dln, _ = ln_linear_bwd(dtt, wq, 2 * cl, x, ln_w, extra_f=extra, shift=-shift, eps=eps)
    dw = torch.zeros((3 * cl, c), dtype=torch.float32, device=dev)
    dw[2 * cl:] = wgrad(un.reshape(-1, c), dtt.reshape(-1, cl)).t()
    dwdw = torch.zeros((3 * cl, 9), dtype=torch.float32, device=dev)
    dwdw[2 * cl:] = dwdw_v.t()
    dtop = dbot = None
    if flags:
        dtop, dbot, dln = _halo_taps_bwd(dv, t_h, _taps(wdw, 2 * cl, cl), wqkv, 2 * cl, rows,
                                         ln_w, eps, halo, un_h, dw[2 * cl:], dwdw[2 * cl:], dln)
        APPLY_BWD_HALO.record(("spectral_apply_bwd_halo", b, h, w, c, ln_w is not None,
                               bool(residual), _gate_kind(gate, h), dp is not None, flags,
                               str(dt)))
    dcomb = wgrad(v.reshape(b, h * w, cl), dys.reshape(b, h * w, c))
    ddp = None if pdp is None else sum_parts(pdp.unsqueeze(-1))[:, 0]
    APPLY_BWD.record(("spectral_apply_bwd", b, h, w, c, shift, ln_w is not None, bool(residual),
                      _gate_kind(gate, h), dp is not None, str(dt)))
    if cl != c:
        APPLY_BWD_TP.record(("spectral_apply_bwd_tp", b, h, w, c, cl, _gate_kind(gate, h),
                             dp is not None, flags, str(dt)))
    dlnw, dlnb = dln if dln is not None else (None, None)
    return (dx, dcomb, dw.reshape(3 * cl, c, 1, 1), dwdw.reshape(3 * cl, 1, 3, 3), dlnw, dlnb,
            None if dgate is None else dgate.to(gate.dtype), dy,
            None if ddp is None else ddp.to(dp_scale.dtype), dtop, dbot)


class _SpectralApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comb, wqkv, wdw, x2, ln_w, ln_b, gate, shortcut, dp_scale, ln2_w, ln2_b,
                w1, b1, w2, b2, htop, hbot, cfg):
        shift, residual, eps, edges = cfg
        halo = _halo_in(htop, hbot, edges)
        mlp = None if w1 is None else (ln2_w, ln2_b, w1, b1, w2, b2)
        ctx.kernel = ROUTE.use_kernel(x)
        if ctx.kernel:
            out = _apply_launch(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate,
                                shortcut, mlp, eps, dp_scale, halo)
        else:
            out = spectral_apply_plain(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate,
                                       shortcut, mlp, eps, dp_scale, halo)
        ctx.cfg = cfg
        ctx.eval_only = dict(x2=x2, mlp=w1)
        ctx.has_shortcut = shortcut is not None
        ctx.save_for_backward(x, comb, wqkv, wdw, ln_w, ln_b, gate, dp_scale, htop, hbot)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, comb, wqkv, wdw, ln_w, ln_b, gate, dp_scale, htop, hbot = ctx.saved_tensors
        shift, residual, eps, edges = ctx.cfg
        _no_eval_only_grad("spectral_apply", **ctx.eval_only)
        dy = dy.contiguous()
        if ctx.kernel:
            fn = _apply_bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = spectral_apply_bwd_plain
        dx, dcomb, dw, dwdw, dlnw, dlnb, dgate, dshort, ddp, dtop, dbot = fn(
            x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps, dy,
            _halo_in(htop, hbot, edges))
        if not ctx.has_shortcut:
            dshort = None
        return (dx, dcomb, dw, dwdw, None, dlnw, dlnb, dgate, dshort, ddp,
                None, None, None, None, None, None, dtop, dbot, None)


def spectral_apply(x, comb, wqkv, wdw, shift: int = 0, x2=None, ln_w=None, ln_b=None,
                   residual: bool = False, gate=None, shortcut=None, mlp=None,
                   eps: float = 1e-5, dp_scale=None, halo: Halo | None = None):
    """Same contract as :func:`spectral_apply_plain`, differentiable without
    ``x2`` / ``mlp`` (the halo rows too: their cotangents go back to
    ``halo.top`` / ``halo.bot``); launches the CUDA kernels on a CUDA
    tensor, with real halo rows in both types."""
    m = (None,) * 6 if mlp is None else tuple(mlp)
    htop, hbot, edges = _halo_args(halo)
    return _SpectralApply.apply(x, comb, wqkv, wdw, x2, ln_w, ln_b, gate, shortcut, dp_scale,
                                *m, htop, hbot, (shift, bool(residual), eps, edges))


# ---------------------------------------------------------------------------
# a row shard of a map split over the spatial mesh axis
# ---------------------------------------------------------------------------

def shard_halo(x, axis: Axis, x2=None) -> Halo:
    """The :class:`Halo` of this row shard of x (and x2, the logical input
    being ``cat([x, x2], -1)``): the neighbour shards' adjacent rows, one
    exchange of each shard's first and last rows (the ``ppermute`` pair of
    ``fused_spectral_attention_sharded``); at the image's top and bottom
    the ring's wrapped rows stand in, marked as edges."""
    rows = torch.cat([x[:, :1], x[:, -1:]], dim=1)
    if x2 is not None:
        rows = torch.cat([rows, torch.cat([x2[:, :1], x2[:, -1:]], dim=1).to(x.dtype)], dim=-1)
    return Halo(*edge_rows(rows, axis, 1))


def spectral_attention_sharded(x, wqkv, wdw, temperature, wout, num_heads: int,
                               axis: Axis | None, x2=None, ln_w=None, ln_b=None,
                               residual: bool = False, gate=None, shortcut=None, mlp=None,
                               eps: float = 1e-5, dp_scale=None):
    """The spectral attention of a map whose rows are split over ``axis``
    (counterpart of ``fused_spectral_attention_sharded``,
    ``mp_hsir_tpu/ops/pallas_attention.py:2148``): this shard's halo rows,
    its stats launch with them, the Gram and norm sums added over the axis,
    the fold, then its apply launch with the same halo rows and the
    epilogue. x is this shard's rows in the unrolled frame (shift 0); the
    options are :func:`spectral_apply`'s. Returns this shard's rows. An
    axis of size 1 (or None) shards nothing: no halo rows, the sums are the
    stats themselves. Differentiable (the training route, without x2 /
    mlp): the halo rows' cotangents go back to the neighbour shards through
    the exchange that brought them, the sums' through their psum."""
    halo = shard_halo(x, axis, x2) if axis_size(axis) > 1 else None
    gram, nq, nk = spectral_stats(x, wqkv, wdw, num_heads, x2=x2, ln_w=ln_w, ln_b=ln_b, eps=eps,
                                  halo=halo)
    b, n_g = gram.shape[0], gram[0].numel()
    sums = psum(torch.cat([gram.reshape(b, -1), nq.reshape(b, -1), nk.reshape(b, -1)], 1), axis)
    nq, nk = (t.reshape(b, num_heads, -1) for t in sums[:, n_g:].chunk(2, dim=1))
    comb = spectral_fold(sums[:, :n_g].reshape(gram.shape), nq, nk, temperature, wout)
    return spectral_apply(x, comb, wqkv, wdw, x2=x2, ln_w=ln_w, ln_b=ln_b, residual=residual,
                          gate=gate, shortcut=shortcut, mlp=mlp, eps=eps, dp_scale=dp_scale,
                          halo=halo)


def spectral_attention_tp(x, wqkv, wdw, temperature, wout, num_heads: int, spectral: Axis,
                          spatial: Axis | None = None, gate=None, shortcut=None,
                          eps: float = 1e-5, dp_scale=None):
    """A member's head block of the spectral attention, summed over the
    ``spectral`` mesh axis (counterpart of ``fused_spectral_attention_tp``,
    ``mp_hsir_tpu/ops/pallas_attention.py:2261``). wqkv (3CL, C, 1, 1), wdw
    (3CL, 1, 3, 3), temperature (``num_heads``, 1, 1) and wout (C, CL, 1, 1)
    are the member's slices (``parallel/tp.py``); x (B, H, W, C) is the whole
    input on every member, or this rank's rows of it when ``spatial`` is
    sharded. :func:`spectral_attention_sharded` runs the head block (the
    fold into comb (B, CL, C), the apply with no LayerNorm and no residual,
    the gate, per-window or a per-pixel map, scaled by 1/n, the drop-path
    scale in-kernel); then the members' partial outputs are summed over the
    axis, and ``shortcut`` added once after the sum. Differentiable."""
    inv = 1.0 / spectral.size  # a power of two on the presets' meshes: exact
    y = spectral_attention_sharded(x, wqkv, wdw, temperature, wout, num_heads, spatial,
                                   gate=None if gate is None else gate * inv, eps=eps,
                                   dp_scale=dp_scale)
    y = psum(y, spectral)
    return y if shortcut is None else (shortcut.float() + y.float()).to(y.dtype)
