"""Bias-free 3x3 convolution (stride 1, zero padding 1) over NHWC maps with
four writebacks: ``plain``, ``res`` (+ float32 residual, float32 output),
``down`` (+ PixelUnshuffle(2)) and ``up`` (+ PixelShuffle(2)).

Kernel: ``csrc/conv3.cu`` (replaces ``_conv3_kernel``,
``_conv3_down_kernel`` and ``_conv3_up_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:1084``, ``:1218``, ``:1243``): an
implicit GEMM on the tensor cores, bf16 on m16n8k16 ``mma.sync``, float32 in
3xTF32 on m16n8k8 (its launches count in :data:`F32_TILE` too). Plain
version: :func:`conv3_plain`. Weight layout: OIHW (Cout, Cin, 3, 3) at the
wrapper; the kernel stages it per block and K chunk from the layout
:func:`pack_weight` makes.

Backward (``_conv3_core``'s VJP, ``mp_hsir_tpu/ops/pallas_vjp.py:1296``):
dx runs the same kernel on the cotangent after the inverse pixel
(un)shuffle, with the weights flipped and transposed; dW is nine products
in PyTorch, as JAX takes them outside Pallas (:func:`conv3_weight_grad`).
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.ops.basic import pixel_shuffle, pixel_unshuffle
from mp_hsir_tpu_torch.ops.conv import conv2d
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import ROUTE, counter, dtype_code, stream_ptr

MODES = {"plain": 0, "res": 1, "down": 2, "up": 3}
COUNTER = counter("conv3")
# the float32 instance (the 3xTF32 tile): ("conv3_f32", B, H, W, Cin, Cout, mode)
F32_TILE = counter("conv3_f32")
# the kernel's input-channel chunk (bf16; float32's is CHUNK_K_F32) and
# output-channel tile: kC3Kt and kC3N of csrc/conv3.cu, which stages the
# layouts pack_weight makes
CHUNK_K, CHUNK_K_F32, TILE_N = 16, 8, 64


def chunk_k(dt: torch.dtype) -> int:
    """The kernel's input-channel chunk in compute type ``dt``."""
    return CHUNK_K_F32 if dt == torch.float32 else CHUNK_K


def conv3_plan(dt: torch.dtype) -> int:
    """The kernel's shared memory per block in ``dt`` (``conv3_smem`` in
    csrc/conv3.cu), whatever the shape: three stages of the 18x18-pixel halo
    (pixel rows of 24 bf16 or 12 float32: 48 bytes) and one K chunk's weight
    slab (9 taps x the chunk x 64 output channels)."""
    size, ld = (4, 12) if dt == torch.float32 else (2, 24)
    return 3 * size * (18 * 18 * ld + 9 * chunk_k(dt) * TILE_N)


def conv3_plain(x: torch.Tensor, w: torch.Tensor, mode: str = "plain",
                res: torch.Tensor | None = None) -> torch.Tensor:
    y = conv2d(x.float(), w.to(x.dtype).float(), padding=1)
    if mode == "res":
        return y + res.float()
    y = y.to(x.dtype)
    if mode == "down":
        return pixel_unshuffle(y, 2)
    if mode == "up":
        return pixel_shuffle(y, 2)
    return y


@lru_cache(maxsize=1)
def _entry():
    import ctypes

    return _build.entry("mp_conv3", 4, [ctypes.c_int] * 7)


def pack_weight(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the kernel's staged layout in ``dt``: bf16
    [ceil(Cout/64)][ceil(Cin/16)][9 taps][16 in][64 out], float32
    [ceil(Cout/64)][ceil(Cin/8)][9 taps][64 out][8 in] (the B operand's rows
    of the m16n8k8 TF32 fragments): the slab of one block's Cout tile and one
    K chunk is contiguous; channels past Cin and Cout are zeros. Tap t =
    3 ky + kx."""
    cout, cin = w.shape[:2]
    ck = chunk_k(dt)
    pad = (0, 0, 0, 0, 0, -cin % ck, 0, -cout % TILE_N)
    wp = F.pad(w, pad) if any(pad) else w
    nt, nc = wp.shape[0] // TILE_N, wp.shape[1] // ck
    view = wp.reshape(nt, TILE_N, nc, ck, 9)
    view = view.permute(0, 2, 4, 1, 3) if dt == torch.float32 else view.permute(0, 2, 4, 3, 1)
    # one copy: the cast and the permutation together
    return torch.empty(view.shape, dtype=dt, device=w.device).copy_(view)


def _launch(x, w, mode, res):
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    if h % 8 or wd % 8 or w.shape[1:] != (cin, 3, 3):
        raise ValueError(f"conv3 needs H, W % 8 == 0 and an OIHW 3x3 weight, got {x.shape}, {w.shape}")
    dt, code = x.dtype, dtype_code(x)
    _build.check_plan("conv3", "mp_conv3_smem", str(dt), code)
    x = x.contiguous()
    wk = pack_weight(w, dt)
    if mode == "res":
        res = res.float().contiguous()
        out = torch.empty((b, h, wd, cout), dtype=torch.float32, device=x.device)
    elif mode == "down":
        out = torch.empty((b, h // 2, wd // 2, 4 * cout), dtype=dt, device=x.device)
    elif mode == "up":
        if cout % 4:
            raise ValueError(f"conv3 up needs Cout % 4 == 0, got {cout}")
        out = torch.empty((b, 2 * h, 2 * wd, cout // 4), dtype=dt, device=x.device)
    else:
        out = torch.empty((b, h, wd, cout), dtype=dt, device=x.device)
    err = _entry()(x.data_ptr(), wk.data_ptr(), _build.ptr(res), out.data_ptr(), code, b, h,
                   wd, cin, cout, MODES[mode], stream_ptr())
    _build.check("mp_conv3", err)
    COUNTER.record(("conv3", b, h, wd, cin, cout, mode, str(dt)))
    if dt == torch.float32:
        F32_TILE.record(("conv3_f32", b, h, wd, cin, cout, mode))
    return out


def conv3_weight_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3) float32 of the stride-1, pad-1 conv: nine
    (BHW, Cin)^T (BHW, Cout) products of the padded input and the cotangent."""
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d2 = dy.float().reshape(-1, cout)
    taps = [d2.t() @ xp[:, ky:ky + h, kx:kx + w, :].reshape(-1, cin)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=-1).reshape(cout, cin, 3, 3)


class _Conv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, res, mode):
        ctx.kernel = ROUTE.use_kernel(x)
        ctx.mode = mode
        ctx.save_for_backward(x, w)
        return (_launch if ctx.kernel else conv3_plain)(x, w, mode, res)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        mode = ctx.mode
        dres = dy if mode == "res" else None
        if mode == "down":
            dy = pixel_shuffle(dy, 2)
        elif mode == "up":
            dy = pixel_unshuffle(dy, 2)
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            wt = w.flip(2, 3).transpose(0, 1)  # dx = conv(dy, flip(w)^T)
            if ctx.kernel:
                dx = _launch(dy, wt, "plain", None)
            else:
                ROUTE.count_plain_backward(x)
                dx = conv3_plain(dy, wt, "plain")
        return dx, conv3_weight_grad(x, dy), dres, None


def conv3(x: torch.Tensor, w: torch.Tensor, mode: str = "plain",
          res: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as :func:`conv3_plain`, differentiable; launches the CUDA
    kernel on a CUDA tensor (forward, and the backward's dx). The dx of an
    input that needs no gradient is not computed."""
    if mode not in MODES or (mode == "res") != (res is not None):
        raise ValueError(f"bad conv3 mode {mode!r} / residual")
    return _Conv3.apply(x, w, res, mode)
