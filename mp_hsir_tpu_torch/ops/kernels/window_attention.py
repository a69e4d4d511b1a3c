"""LayerNorm + 8x8 shifted-window attention + projection + window means.

Kernel: ``csrc/window_attention.cu`` (replaces the TPU kernels
``_nhwc_kernel`` and the window half of ``_nhwc_sp0_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:198`` and ``:362``). The backward
replaces ``_win_bwd_kernel`` (``mp_hsir_tpu/ops/pallas_vjp.py:539``): in
bf16 two tensor-core tiles, ``mp_window_attention_bwd_tc`` (the per-window
recompute and attention backward) and ``mp_window_attention_dx_tc``
(``csrc/dwconv_dx.cuh`` without its stencil: dxn = dqkv Wqkv and the
LayerNorm backward), then ``csrc/grad.cu``'s two weight products and one
in-order sum of the per-window partials (:func:`window_bwd_tc_plan` mirrors
both plans); in float32 ``mp_window_attention_bwd`` (SIMT) and grad.cu's
``ln_linear_bwd``, weight products and sums. Plain versions:
:func:`window_attention_plain` and :func:`window_attention_bwd_plain`, the
same arithmetic in PyTorch.

The forward runs one tile design in both types: bf16 on m16n8k16
``mma.sync`` (``window_tc_kernel``), float32 in 3xTF32 on m16n8k8
(``window_f32_kernel``, its launches counted in :data:`F32_TILE` too; its
plan is :func:`window_f32_plan`). A head width over 128, or a width whose
plan does not fit the device, raises.

Weight layouts at the launch: the forward streams the head-major packs of
:func:`pack_qkv_weight` and :func:`pack_proj_weight` in its type; the bf16
backward those of :func:`pack_qkv_weight` and :func:`pack_proj_t_weight`
and the torch qkv weight (rows padded to 16 bytes); the float32 backward
takes [in][out] copies; all made on every call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch import upload
from mp_hsir_tpu_torch.ops.basic import layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._grad import (
    col_ptr, grad_or_zeros, ln_bwd_plain, ln_linear_bwd, ln_stats, sum_parts, wgrad,
)
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.kernels.mlp import TAIL_MAX_C
from mp_hsir_tpu_torch.ops.kernels.spectral import dwconv_dx_plan
from mp_hsir_tpu_torch.ops.window import (
    roll_hw, shifted_region_map, window_partition, window_reverse,
)

WS = 8
# the bf16 kernel's head widths and weight-tile depth: tc_head_width and
# kTcK of csrc/window_attention.cu, which stream the layouts the packs make
HEAD_WIDTHS = (16, 32, 48, 64, 96, 128)
K_CHUNK = 64
# the ring's row stride (kTcLd) and its bytes target (tc_stages); the
# float32 tile's (kTcLdF, kTcF32Ring: tc_f32_stages)
TC_LD = K_CHUNK + 8
RING_BYTES = 40960
TC_LD_F32 = K_CHUNK + 4
RING_BYTES_F32 = 26624
COUNTER = counter("window_attention")
# the float32 forward (the 3xTF32 tile): ("window_attention_f32", B, H, W, C, heads, shift)
F32_TILE = counter("window_attention_f32")
BWD = counter("window_attention_bwd")
# the launches on a row shard with its region labels:
# ("window_attention_shard", B, H, W, C, heads, dtype)
SHARD = counter("window_attention_shard")
# the backward launches on a row shard, masked by its region labels
SHARD_BWD = counter("window_attention_bwd_shard")


@lru_cache(maxsize=32)
def region_labels(h: int, w: int, shift: int, device: torch.device) -> torch.Tensor:
    """(H, W) int32 shift-region labels of the rolled frame, on ``device``."""
    return upload(shifted_region_map(h, w, WS, shift), device)


def window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads: int,
                           shift: int = 0, eps: float = 1e-5, region=None):
    """x (B, H, W, C) unrolled; wqkv (3C, C), bqkv (3C,), rel_bias (nH, 64, 64),
    wp (C, C), bp (C,). Returns (out (B, H, W, C) in the rolled frame,
    pooled (B, H/8, W/8, C) window means). ``region`` (H, W) int32: x is a
    row shard already in the rolled frame (shift 0), whose windows mask by
    these labels, the global map's rows of the shard (JAX
    ``models/layers.py:1098-1101``)."""
    b, h, w, c = x.shape
    dt = x.dtype
    dh = c // num_heads
    xr = roll_hw(x, -shift, -shift) if shift else x
    xn = window_partition(layer_norm(xr, ln_w, ln_b, eps), WS).float()  # (Bw, 64, C)
    qkv = (xn @ wqkv.to(dt).float().t() + bqkv.float()).to(dt).float()
    bw, n = qkv.shape[:2]
    qkv = qkv.reshape(bw, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)  # (3, Bw, nH, N, dh)
    s = (qkv[0] @ qkv[1].transpose(-1, -2)) * dh ** -0.5 + rel_bias.float()[None]
    labels = _labels(h, w, shift, x.device, region)
    if labels is not None:
        mask = _window_mask(labels)
        s = (s.reshape(b, -1, num_heads, n, n) + mask[None, :, None]).reshape(bw, num_heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ qkv[2]).to(dt).float()  # (Bw, nH, N, dh)
    o = o.permute(0, 2, 1, 3).reshape(bw, n, c)
    y = (o @ wp.to(dt).float().t() + bp.float()).to(dt)
    pooled = y.float().mean(dim=1).to(dt).reshape(b, h // WS, w // WS, c)
    return window_reverse(y, WS, h, w), pooled


def _labels(h, w, shift, device, region=None):
    """The (H, W) region labels the windows mask by, or None: a shard's
    ``region`` (shift 0), else the map's own at ``shift``."""
    if region is not None:
        if shift:
            raise ValueError("a shard with its region labels is already rolled: shift 0")
        if tuple(region.shape) != (h, w):
            raise ValueError(f"region labels must be {(h, w)}, got {tuple(region.shape)}")
        return region.to(device=device, dtype=torch.int32).contiguous()
    return region_labels(h, w, shift, device) if shift else None


def _window_mask(labels):
    """(nW, 64, 64) additive {0, -100} mask of the rolled frame's labels."""
    lab = window_partition(labels[None, :, :, None], WS)[..., 0]
    return torch.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)


def window_attention_bwd_plain(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift,
                               eps, dout, dpool, region=None):
    """Explicit VJP of :func:`window_attention_plain` at cotangents (dout in
    the rolled frame, dpool): returns (dx, d ln_w, d ln_b, d wqkv, d bqkv,
    d rel_bias, d wp, d bp), weight cotangents float32. ``region``: the
    labels the forward masked by (a row shard's, at shift 0)."""
    b, h, w, c = x.shape
    dt = x.dtype
    dh = c // num_heads
    scale = dh ** -0.5
    xr = roll_hw(x, -shift, -shift) if shift else x
    xhat, rstd = ln_stats(xr, eps)
    xn = window_partition(layer_norm(xr, ln_w, ln_b, eps), WS).float()  # (Bw, 64, C)
    wq = wqkv.to(dt).float()
    qkv = (xn @ wq.t() + bqkv.float()).to(dt).float()
    bw, n = qkv.shape[:2]
    q, k, v = qkv.reshape(bw, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)  # (Bw, nH, N, dh)
    s = (q @ k.transpose(-1, -2)) * scale + rel_bias.float()[None]
    labels = _labels(h, w, shift, x.device, region)
    if labels is not None:
        mask = _window_mask(labels)
        s = (s.reshape(b, -1, num_heads, n, n) + mask[None, :, None]).reshape(bw, num_heads, n, n)
    a = torch.softmax(s, dim=-1)
    ar = a.to(dt).float()
    o = (ar @ v).to(dt).float().permute(0, 2, 1, 3).reshape(bw, n, c)
    dyt = window_partition(dout.float(), WS) + dpool.float().reshape(bw, 1, c) / n
    dbp = dyt.sum(dim=(0, 1))
    dy2 = dyt.to(dt).float()
    dwp = dy2.reshape(-1, c).t() @ o.reshape(-1, c)
    do = (dy2 @ wp.to(dt).float()).to(dt).float()
    do = do.reshape(bw, n, num_heads, dh).permute(0, 2, 1, 3)
    da = do @ v.transpose(-1, -2)
    ds = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=0)
    dsr = ds.to(dt).float()
    dq = dsr @ k * scale
    dk = dsr.transpose(-1, -2) @ q * scale
    dv = ar.transpose(-1, -2) @ do
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(bw, n, 3 * c).to(dt).float()
    dbqkv = dqkv.sum(dim=(0, 1))
    dwqkv = dqkv.reshape(-1, 3 * c).t() @ xn.reshape(-1, c)
    dxn = window_reverse(dqkv @ wq, WS, h, w)
    dxr, dlnw, dlnb = ln_bwd_plain(dxn, xhat, rstd, ln_w)
    dx = roll_hw(dxr, shift, shift) if shift else dxr
    return dx.to(dt), dlnw, dlnb, dwqkv, dbqkv, dbias, dwp, dbp


@lru_cache(maxsize=None)
def _entry(kind: str = "fwd"):
    import ctypes

    if kind == "bwd":
        return _build.entry("mp_window_attention_bwd", 16, [ctypes.c_int] * 7 + [ctypes.c_float])
    if kind == "bwd_tc":
        return _build.entry("mp_window_attention_bwd_tc", 15,
                            [ctypes.c_int] * 7 + [ctypes.c_float])
    if kind == "dx_tc":
        return _build.entry("mp_window_attention_dx_tc", 6, [ctypes.c_int] * 6 + [ctypes.c_float])
    return _build.entry("mp_window_attention", 11,
                        [ctypes.c_int] * 7 + [ctypes.c_float])


def head_width(dh: int) -> int:
    """The bf16 kernel's padded head width for head width ``dh``: the least
    of :data:`HEAD_WIDTHS` that holds it; ValueError past 128."""
    for d in HEAD_WIDTHS:
        if dh <= d:
            return d
    raise ValueError(f"the bf16 window kernels take head widths up to {HEAD_WIDTHS[-1]}, got {dh}")


def _round_k(n: int) -> int:
    return -(-n // K_CHUNK) * K_CHUNK


def pack_qkv_weight(wqkv: torch.Tensor, num_heads: int, dt: torch.dtype) -> torch.Tensor:
    """(3C, C) torch-Linear qkv weight -> the bf16 kernel's head-major
    [nH][3][DHP][round64(C)] in ``dt``: slab h holds head h's q, k and v rows
    (rows s*C + h*dh + r of ``wqkv``), zero past dh and past C. Any (S C, C)
    stack of row sections packs the same way, as [nH][S][DHP][round64(C)]."""
    c = wqkv.shape[1]
    dh = c // num_heads
    dhp, kx = head_width(dh), _round_k(c)
    view = wqkv.reshape(-1, num_heads, dh, c).transpose(0, 1)
    if dhp == dh and kx == c:  # one copy: the cast and the permutation together
        return torch.empty(view.shape, dtype=dt, device=wqkv.device).copy_(view)
    out = torch.zeros((num_heads, view.shape[1], dhp, kx), dtype=dt, device=wqkv.device)
    out[:, :, :dh, :c] = view
    return out


def pack_proj_weight(wp: torch.Tensor, num_heads: int, dt: torch.dtype) -> torch.Tensor:
    """(C, C) torch-Linear projection weight -> [nH][DHP][round64(nH DHP)] in
    ``dt``: chunk j holds output rows j*dh + r, their input column h*dh + d at
    h*DHP + d (the heads' output as the kernel packs it), zero elsewhere."""
    c = wp.shape[0]
    dh = c // num_heads
    dhp = head_width(dh)
    ko = _round_k(num_heads * dhp)
    view = wp.reshape(num_heads, dh, num_heads, dh)
    if dhp == dh and ko == c:
        return torch.empty((num_heads, dh, c), dtype=dt, device=wp.device).copy_(
            view.reshape(num_heads, dh, c))
    out = torch.zeros((num_heads, dhp, ko), dtype=dt, device=wp.device)
    out[:, :dh, :num_heads * dhp].unflatten(-1, (num_heads, dhp))[..., :dh] = view
    return out


def pack_proj_t_weight(wp: torch.Tensor, num_heads: int, dt: torch.dtype) -> torch.Tensor:
    """(C, C) torch-Linear projection weight -> the bf16 backward's
    [nH][DHP][round64(C)] in ``dt``: slab h row j holds column h*dh + j of
    ``wp`` (do = dy Wp reads it as head h's [DHP][C] weight tiles), zero past
    dh and past C."""
    return pack_qkv_weight(wp.t(), num_heads, dt)[:, 0]


def tc_stages(dhp: int) -> int:
    """The weight ring's stages at padded head width ``dhp`` (``tc_stages``
    in csrc/window_attention.cu): about 40 KB of [DHP][72] tiles, 2 to 6, 2
    at dhp >= 96."""
    return 2 if dhp >= 96 else min(6, RING_BYTES // (dhp * TC_LD * 2))


def window_bwd_tc_plan(c: int, heads: int) -> dict:
    """The bf16 backward's plans at (C, heads): tile 1's (``window_bwd_tc_smem``
    in csrc/window_attention.cu: LN(x) and the rounded dy [64][``kx`` + 8],
    q, k, v, do [64][``dhp`` + 8], rnd(dS) and rnd(A) [64][72], ``stages``
    [dhp][72] weight tiles; ``bytes`` dynamic) and tile 2's (``dx``:
    :func:`dwconv_dx_plan` without the stencil at K = 3C)."""
    dhp, kx = head_width(c // heads), _round_k(c)
    stages = tc_stages(dhp)
    nbytes = 2 * (2 * 64 * (kx + 8) + 4 * 64 * (dhp + 8) + 2 * 64 * TC_LD + stages * dhp * TC_LD)
    return dict(dhp=dhp, kx=kx, stages=stages, bytes=nbytes,
                dx=dwconv_dx_plan(c, 3 * c, stencil=False))


def tc_f32_stages(dhp: int) -> int:
    """The float32 tile's weight ring stages at padded head width ``dhp``
    (``tc_f32_stages`` in csrc/window_attention.cu): about 26 KB of
    [DHP][68] float32 tiles, 2 to 6."""
    return max(2, min(6, RING_BYTES_F32 // (dhp * TC_LD_F32 * 4)))


def window_f32_plan(c: int, heads: int, limit: int = 232448) -> dict:
    """The float32 tile's plan at (C, heads) (``window_f32_smem`` in
    csrc/window_attention.cu), dynamic bytes: the window [64][``ldx``], O of
    the block's heads [64][``ldo``], k [64][DHP + 8], v [64][DHP + 4] and
    ``stages`` [DHP][68] ring tiles. ``one``: one block per window (O
    whole); ``two``: the heads split over a two-block cluster (O half, then
    assembled in the window's buffer). ``blocks``: the split the plan needs
    within ``limit`` bytes (the device's opt-in limit less the static
    bytes): 1, 2, or 0 where neither fits; ``bytes``: its plan."""
    dhp = head_width(c // heads)
    kx, ko = _round_k(c), _round_k(heads * dhp)
    stages = tc_f32_stages(dhp)
    ldx = max(kx, ko) + 4

    def plan(g):
        ldo = (ko if g == 1 else heads // g * dhp) + 4
        return 4 * (64 * ldx + 64 * ldo + 64 * (2 * dhp + 12) + stages * dhp * TC_LD_F32)

    one, two = plan(1), plan(2) if heads % 2 == 0 else None
    blocks = 1 if one <= limit else 2 if two is not None and two <= limit else 0
    return dict(dhp=dhp, kx=kx, ko=ko, ldx=ldx, stages=stages, one=one, two=two, blocks=blocks,
                bytes=one if blocks != 2 else two)


def _prepare(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift, eps, region=None):
    """Everything a launch needs: (the C entry's arguments, (out, pooled),
    the tensors the arguments point into, to be held until the launch). The
    kernel masks wherever it is given labels, and rolls by ``shift``: a
    shard's ``region`` goes in with shift 0."""
    b, h, w, c = x.shape
    if h % WS or w % WS or c % num_heads:
        raise ValueError(f"window attention needs H, W % 8 == 0 and C % heads == 0, got {x.shape}")
    dt = x.dtype
    code = dtype_code(x)
    _build.check_plan("window_attention", "mp_window_attention_smem", f"C={c}, heads={num_heads}",
                      c, num_heads, code)
    x = x.contiguous()
    wq, wpk = pack_qkv_weight(wqkv, num_heads, dt), pack_proj_weight(wp, num_heads, dt)
    lnw, lnb, bq, bpf, bias = f32(ln_w), f32(ln_b), f32(bqkv), f32(bp), f32(rel_bias)
    labels = _labels(h, w, shift, x.device, region)
    out = torch.empty_like(x)
    pooled = torch.empty((b, h // WS, w // WS, c), dtype=dt, device=x.device)
    args = (x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            bias.data_ptr(), _build.ptr(labels), wpk.data_ptr(), bpf.data_ptr(), out.data_ptr(),
            pooled.data_ptr(), code, b, h, w, c, num_heads, shift, eps, stream_ptr())
    return args, (out, pooled), (x, wq, wpk, lnw, lnb, bq, bpf, bias, labels)


def _launch(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift, eps, region=None):
    args, out, _held = _prepare(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift, eps,
                                region)
    _build.check("mp_window_attention", _entry()(*args))
    b, h, w, c = x.shape
    COUNTER.record(("window_attention", b, h, w, c, num_heads, shift, str(x.dtype)))
    if x.dtype == torch.float32:
        F32_TILE.record(("window_attention_f32", b, h, w, c, num_heads, shift))
    if region is not None:
        SHARD.record(("window_attention_shard", b, h, w, c, num_heads, str(x.dtype)))
    return out


def _bwd_tc_launch(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift, eps, dout,
                   dpool, region=None):
    """The bf16 backward: the two tiles, the two weight products and one
    in-order sum of the per-window partial rows (dS [nH][64][64] | bp [C] from
    tile 1, dbqkv [3C] | d ln_w | d ln_b from tile 2)."""
    b, h, w, c = x.shape
    dt = x.dtype
    if c > TAIL_MAX_C:  # tile 2 keeps dxn in registers up to kTailMaxC
        raise ValueError(f"the bf16 window attention backward takes C up to {TAIL_MAX_C}, "
                         f"got {c}")
    what = f"C={c}, heads={num_heads}"
    _build.check_plan("window_attention_bwd", "mp_window_attention_bwd_tc_smem", what, c,
                      num_heads)
    _build.check_plan("window_attention_bwd", "mp_window_attention_dx_tc_smem", what, c)
    x = x.contiguous()
    dout, dpool = dout.to(dt).contiguous(), dpool.to(dt).contiguous()
    wq, wpt = pack_qkv_weight(wqkv, num_heads, dt), pack_proj_t_weight(wp, num_heads, dt)
    wrows = wqkv.to(dt)
    if c % 8:  # 16-byte rows for the tile's copies
        wrows = F.pad(wrows, (0, -c % 8))
    wrows = wrows.contiguous()
    lnw, lnb, bq, bias = f32(ln_w), f32(ln_b), f32(bqkv), f32(rel_bias)
    labels = _labels(h, w, shift, x.device, region)
    dev = x.device
    n_win = b * (h // WS) * (w // WS)
    nb = num_heads * 64 * 64
    ldp = nb + 6 * c
    xn, o, dyt, dx = (torch.empty_like(x) for _ in range(4))
    dqkv = torch.empty((b, h, w, 3 * c), dtype=dt, device=dev)
    part = torch.empty((1, n_win, ldp), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _entry("bwd_tc")(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wq.data_ptr(),
                           bq.data_ptr(), bias.data_ptr(), p(labels), wpt.data_ptr(),
                           dout.data_ptr(), dpool.data_ptr(), xn.data_ptr(), o.data_ptr(),
                           dyt.data_ptr(), dqkv.data_ptr(), part.data_ptr(), ldp, b, h, w, c,
                           num_heads, shift, eps, stream_ptr())
    _build.check("mp_window_attention_bwd_tc", err)
    err = _entry("dx_tc")(dqkv.data_ptr(), wrows.data_ptr(), x.data_ptr(), lnw.data_ptr(),
                          dx.data_ptr(), col_ptr(part[0], nb + c), ldp, b, h, w, c, shift, eps,
                          stream_ptr())
    _build.check("mp_window_attention_dx_tc", err)
    dwqkv = wgrad(xn.reshape(-1, c), dqkv.reshape(-1, 3 * c)).t()
    dwp = wgrad(o.reshape(-1, c), dyt.reshape(-1, c)).t()
    sums = sum_parts(part)[0]
    dbias, dbp, dbqkv, dlnw, dlnb = sums.split([nb, c, 3 * c, c, c])
    _record_bwd(b, h, w, c, num_heads, shift, dt, region)
    return dx, dlnw, dlnb, dwqkv, dbqkv, dbias.reshape(num_heads, 64, 64), dwp, dbp


def _record_bwd(b, h, w, c, num_heads, shift, dt, region):
    BWD.record(("window_attention_bwd", b, h, w, c, num_heads, shift, str(dt)))
    if region is not None:
        SHARD_BWD.record(("window_attention_bwd_shard", b, h, w, c, num_heads, str(dt)))


def _bwd_launch(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift, eps, dout, dpool,
                region=None):
    if x.dtype == torch.bfloat16:
        return _bwd_tc_launch(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads, shift, eps,
                              dout, dpool, region)
    b, h, w, c = x.shape
    dt = x.dtype
    kc = _build.chunk("mp_window_attention_bwd_chunk", c, num_heads)
    _build.check_plan("window_attention_bwd", "mp_window_attention_bwd_smem",
                      f"C={c}, heads={num_heads}", c, num_heads, kc)
    x = x.contiguous()
    dout, dpool = dout.to(dt).contiguous(), dpool.to(dt).contiguous()
    wq, wpk = kernel_weight(wqkv, dt), kernel_weight(wp, dt)
    lnw, lnb, bq, bias = f32(ln_w), f32(ln_b), f32(bqkv), f32(rel_bias)
    labels = _labels(h, w, shift, x.device, region)
    dev = x.device
    n_win = b * (h // WS) * (w // WS)
    xn, o, dyt = (torch.empty_like(x) for _ in range(3))
    dqkv = torch.empty((b, h, w, 3 * c), dtype=dt, device=dev)
    pbias = torch.empty((n_win, num_heads * 64 * 64), dtype=torch.float32, device=dev)
    pbp = torch.empty((n_win, c), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _entry("bwd")(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wq.data_ptr(),
                        bq.data_ptr(), bias.data_ptr(), p(labels), wpk.data_ptr(), dout.data_ptr(),
                        dpool.data_ptr(), xn.data_ptr(), o.data_ptr(), dyt.data_ptr(),
                        dqkv.data_ptr(), pbias.data_ptr(), pbp.data_ptr(), b, h, w, c, num_heads,
                        shift, kc, eps, stream_ptr())
    _build.check("mp_window_attention_bwd", err)
    dx, (dlnw, dlnb), dbqkv = ln_linear_bwd(dqkv, wq, 0, x, ln_w, shift=shift, eps=eps, bias=True)
    dwqkv = wgrad(xn.reshape(-1, c), dqkv.reshape(-1, 3 * c)).t()
    dwp = wgrad(o.reshape(-1, c), dyt.reshape(-1, c)).t()
    dbias = sum_parts(pbias.unsqueeze(0))[0].reshape(num_heads, 64, 64)
    dbp = sum_parts(pbp.unsqueeze(0))[0]
    _record_bwd(b, h, w, c, num_heads, shift, dt, region)
    return dx, dlnw, dlnb, dwqkv, dbqkv, dbias, dwp, dbp


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, cfg, region):
        ctx.kernel = ROUTE.use_kernel(x)
        out = (_launch if ctx.kernel else window_attention_plain)(
            x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, *cfg, region)
        ctx.cfg = cfg
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, region)
        return out

    @staticmethod
    def backward(ctx, dout, dpool):
        *saved, region = ctx.saved_tensors
        x = saved[0]
        b, h, w, c = x.shape
        dout = grad_or_zeros(dout, x)
        dpool = grad_or_zeros(dpool, x.new_empty((b, h // WS, w // WS, c)))
        if ctx.kernel:
            fn = _bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = window_attention_bwd_plain
        return (*fn(*saved, *ctx.cfg, dout, dpool, region), None, None)


def window_attention(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads: int,
                     shift: int = 0, eps: float = 1e-5, region=None):
    """Same contract as :func:`window_attention_plain`, differentiable (a
    row shard's backward masks by the ``region`` labels its forward took);
    launches the CUDA kernels on a CUDA tensor."""
    return _WindowAttention.apply(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp,
                                  (num_heads, shift, eps), region)


def relative_position_index(ws: int = WS) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)
