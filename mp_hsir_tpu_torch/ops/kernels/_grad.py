"""Shared stages of the backward kernels (``csrc/grad.cu``) and the plain
PyTorch versions of the same backward math.

Each kernel module's backward tile kernel writes per-pixel operands; the
functions here finish the backward from them on the card: weight products
(:func:`wgrad`), the 3x3 depthwise-conv backward (:func:`dwconv_bwd`), the
1x1 + LayerNorm backward with its cyclic roll back into the input's frame
(:func:`ln_linear_bwd`) and in-order sums of per-block partials
(:func:`sum_parts`). Every cross-block reduction is a fixed-order second pass:
a train step gives the same gradients on every run.

The ``*_plain`` functions are the explicit backward math the plain versions
of the kernel modules share (no autograd).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import ROUTE, counter, dtype_code, stream_ptr

WGRAD = counter("wgrad")
# the bf16 weight product's tile map (kWT, kWP, kWS in csrc/grad.cu): output
# tiles of WGRAD_TILE x WGRAD_TILE, WGRAD_DEPTH pixels per ring stage,
# WGRAD_RING stages
WGRAD_TILE, WGRAD_DEPTH, WGRAD_RING = 128, 32, 4
WGRAD_BLOCKS = 4 * 132  # (tile, part) blocks to aim for: two waves of two blocks per H100 SM
WGRAD_MIN_PIX = 1024    # pixels a part sums at least (its partial is small beside its operands)


def dwconv3_f32(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 depthwise conv with zero padding in float32, as nine shifted
    products summed in tap order: t (B, H, W, C), w (C, 1, 3, 3)."""
    b, h, wd, c = t.shape
    tp = F.pad(t.float(), (0, 0, 1, 1, 1, 1))
    w9 = w.float().reshape(c, 9)
    acc = torch.zeros((b, h, wd, c), dtype=torch.float32, device=t.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc = acc + tp[:, dy:dy + h, dx:dx + wd, :] * w9[:, tap]
    return acc


def dwconv3_bwd_plain(dout: torch.Tensor, t: torch.Tensor, w: torch.Tensor):
    """Backward of :func:`dwconv3_f32` at cotangent ``dout``: (dt, dw) with dt
    the transposed stencil (float32) and dw (C, 1, 3, 3) float32."""
    b, h, wd, c = t.shape
    dt = dwconv3_f32(dout, w.flip(2, 3))
    tp = F.pad(t.float(), (0, 0, 1, 1, 1, 1))
    dw = torch.stack([(tp[:, dy:dy + h, dx:dx + wd, :] * dout).sum(dim=(0, 1, 2))
                      for dy in range(3) for dx in range(3)], dim=1)
    return dt, dw.reshape(c, 1, 3, 3)


def ln_stats(x: torch.Tensor, eps: float):
    """(xhat, rstd) of the float32 LayerNorm over the last axis."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def ln_bwd_plain(dxn: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, w: torch.Tensor):
    """LayerNorm backward: (dx, d weight, d bias), all float32."""
    dims = tuple(range(dxn.dim() - 1))
    dlnw = (dxn * xhat).sum(dim=dims)
    dlnb = dxn.sum(dim=dims)
    g = dxn * w.float()
    dx = (g - g.mean(dim=-1, keepdim=True) - xhat * (g * xhat).mean(dim=-1, keepdim=True)) * rstd
    return dx, dlnw, dlnb


# ---------------------------------------------------------------------------
# launches of csrc/grad.cu
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _entry(name: str):
    if name == "mp_wgrad":
        return _build.entry(name, 4, [ctypes.c_int] * 6)
    if name == "mp_dwconv_bwd":
        return _build.entry(name, 6, [ctypes.c_int] * 6)
    if name == "mp_dwconv_halo_bwd":
        return _build.entry(name, 6, [ctypes.c_int] * 6)
    if name == "mp_ln_linear_bwd":
        return _build.entry(name, 11, [ctypes.c_int] * 8 + [ctypes.c_float])
    if name == "mp_sum_parts":
        return _build.entry(name, 2, [ctypes.c_int] * 3)
    raise KeyError(name)


def col_ptr(t: torch.Tensor, col0: int) -> int:
    """Device pointer of column ``col0`` of a row-major matrix."""
    return t.data_ptr() + col0 * t.element_size()


def wgrad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`wgrad`: the float32 sum over pixels of
    a^T b, a (nb, P, M) or (P, M), b likewise with N columns."""
    return torch.einsum("...pm,...pn->...mn", a.float(), b.float())


def wgrad_plan(nb: int, p: int, m: int, n: int, bf16: bool = True) -> tuple[int, int]:
    """(n_parts, pixels per part) of a weight product, a pure function of the
    shape: each (output tile, part) block sums the pixel range [i * chunk,
    min(P, (i + 1) * chunk)) of part i into its own partial, and the partials
    are added in order after. bf16 (the tensor-core kernel): 128 x 128 tiles,
    enough parts for WGRAD_BLOCKS blocks, each part at least WGRAD_MIN_PIX
    pixels; float32 (the SIMT kernel): its 64 x 64 tiles and 512 blocks of at
    least 256 pixels, as before."""
    if bf16:
        tiles = nb * -(-m // WGRAD_TILE) * -(-n // WGRAD_TILE)
        n_parts = max(1, min(p // WGRAD_MIN_PIX, -(-WGRAD_BLOCKS // tiles)))
    else:
        n_parts = max(1, min(p // 256, -(-512 // (nb * -(-m // 64) * -(-n // 64)))))
    per = -(-p // n_parts)
    return n_parts, -(-per // WGRAD_DEPTH) * WGRAD_DEPTH


def wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over pixels of a^T b: a (nb, P, M) or (P, M) and b likewise with N
    columns, in the compute type; returns float32 (nb, M, N) or (M, N). A CPU
    tensor takes :func:`wgrad_plain`; a CUDA tensor launches grad.cu's
    kernel (bf16: ``wgrad_tc_kernel`` on the tensor cores)."""
    if not ROUTE.use_kernel(a):
        return wgrad_plain(a, b)
    if b.dtype != a.dtype:
        raise TypeError(f"wgrad takes operands of one dtype, got {a.dtype} and {b.dtype}")
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a.unsqueeze(0), b.unsqueeze(0)
    a, b = a.contiguous(), b.contiguous()
    nb, p, m = a.shape
    n = b.shape[-1]
    n_parts, _ = wgrad_plan(nb, p, m, n, a.dtype == torch.bfloat16)
    dev = a.device
    part = torch.empty((nb, n_parts, m, n), dtype=torch.float32, device=dev) if n_parts > 1 else None
    out = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    err = _entry("mp_wgrad")(a.data_ptr(), b.data_ptr(), _build.ptr(part), out.data_ptr(),
                             dtype_code(a), nb, p, m, n, n_parts, stream_ptr())
    _build.check("mp_wgrad", err)
    WGRAD.record(("wgrad", nb, p, m, n, str(a.dtype)))
    return out[0] if squeeze else out


def dwconv_bwd(dout: torch.Tensor, t: torch.Tensor, wk: torch.Tensor, col0: int, dt: torch.dtype):
    """Depthwise backward on the card: dout, t (B, H, W, Cn) float32; wk the
    forward's [9][ldw] taps in ``dt`` with this conv's channels from ``col0``.
    Returns (d input (B, H, W, Cn) in ``dt``, d taps (9, Cn) float32), t read
    as zero beyond the map (a row shard's halo rows: :func:`dwconv_halo_bwd`)."""
    b, h, w, cn = dout.shape
    tiles = b * (h // 8) * (w // 8)
    dx = torch.empty((b, h, w, cn), dtype=dt, device=dout.device)
    part = torch.empty((tiles, 9, cn), dtype=torch.float32, device=dout.device)
    dw = torch.empty((9, cn), dtype=torch.float32, device=dout.device)
    err = _entry("mp_dwconv_bwd")(dout.data_ptr(), t.data_ptr(), col_ptr(wk, col0), dx.data_ptr(),
                                  part.data_ptr(), dw.data_ptr(), dtype_code(dx), b, h, w, cn,
                                  wk.shape[1], stream_ptr())
    _build.check("mp_dwconv_bwd", err)
    return dx, dw


def dwconv_halo_bwd(dout: torch.Tensor, t_halo: torch.Tensor, taps: torch.Tensor, halo: int):
    """The halo-row terms of a row shard's depthwise backward on the card
    (grad.cu's ``mp_dwconv_halo_bwd``), which the stencil kernels leave
    out: dout (B, H, W, K) float32 at the depthwise output, t_halo
    [2][B][W][K] the halo rows' depthwise input (above, below), taps [K][9],
    both in the compute type; ``halo`` bit 0 / 1: the row above / below is
    real. Returns (the halo rows' cotangents [2][B][W][K] in the compute
    type, zero on a side without its bit; the taps' gradient share [2][3][K]
    float32 of the taps' first row (side 0) and last row (side 1))."""
    b, h, w, k = dout.shape
    dev = dout.device
    dt_halo = torch.empty((2, b, w, k), dtype=t_halo.dtype, device=dev)
    part = torch.empty((2, b * (w // 8), 3, k), dtype=torch.float32, device=dev)
    dw = torch.empty((2, 3, k), dtype=torch.float32, device=dev)
    err = _entry("mp_dwconv_halo_bwd")(dout.data_ptr(), t_halo.data_ptr(), taps.data_ptr(),
                                       dt_halo.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                       dtype_code(t_halo), b, h, w, k, halo, stream_ptr())
    _build.check("mp_dwconv_halo_bwd", err)
    return dt_halo, dw


def ln_linear_bwd(d: torch.Tensor, wk: torch.Tensor, col0: int, x: torch.Tensor, ln_w=None,
                  extra_t=None, extra_f=None, shift: int = 0, eps: float = 1e-5,
                  bias: bool = False):
    """dx of ``[LN ->] 1x1`` on the card: d (B, H, W, K) the cotangent at the
    1x1 output in the kernel frame; wk the forward's [C][ldw] operand with
    this layer's K columns from ``col0``; x (B, H, W, C) the layer input, whose
    pixel (r + shift, c + shift) is the kernel frame's (r, c). Returns (dx in
    x's frame, (d LN weight, d LN bias) or None, d 1x1 bias (K,) or None)."""
    b, h, w, k = d.shape
    c = x.shape[-1]
    tiles = b * (h // 8) * (w // 8)
    dev = d.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    lnw = None if ln_w is None else ln_w.float().contiguous()
    lnpart = dln = bpart = dbias = None
    if lnw is not None:
        lnpart, dln = torch.empty((tiles, 2 * c), **f32), torch.empty((2, c), **f32)
    if bias:
        bpart, dbias = torch.empty((tiles, k), **f32), torch.empty((k,), **f32)
    p = _build.ptr
    err = _entry("mp_ln_linear_bwd")(d.data_ptr(), col_ptr(wk, col0), x.data_ptr(), p(lnw),
                                     p(extra_t), p(extra_f), dx.data_ptr(), p(lnpart), p(dln),
                                     p(bpart), p(dbias), dtype_code(x), b, h, w, c, k,
                                     wk.shape[1], shift, eps, stream_ptr())
    _build.check("mp_ln_linear_bwd", err)
    return dx, (None if dln is None else (dln[0], dln[1])), dbias


def sum_parts(part: torch.Tensor) -> torch.Tensor:
    """(nb, n_parts, ...) float32 partials -> (nb, ...) in-order sums."""
    nb, n_parts = part.shape[:2]
    out = torch.empty((nb,) + tuple(part.shape[2:]), dtype=torch.float32, device=part.device)
    err = _entry("mp_sum_parts")(part.data_ptr(), out.data_ptr(), nb, n_parts,
                                 part[0, 0].numel(), stream_ptr())
    _build.check("mp_sum_parts", err)
    return out


def grad_or_zeros(g, like: torch.Tensor) -> torch.Tensor:
    """An output cotangent autograd passed as None, as zeros."""
    return torch.zeros_like(like) if g is None else g.contiguous()
