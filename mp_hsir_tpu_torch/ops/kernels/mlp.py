"""LayerNorm + gated MLP over NHWC maps with an optional residual and a
per-sample drop-path scale: the PGSSTB tail on the training route,
``[x +] s_b * (fc2(a * gelu(g)) + b2)``, ``[a | g] = fc1(LN(x)) + b1``.

Kernels: ``csrc/mlp.cu`` ``mp_mlp`` (replaces ``_mlp_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:965``, host ``_mlp_fwd_call`` :996);
the backward (replaces ``_mlp_bwd_kernel``,
``mp_hsir_tpu/ops/pallas_vjp.py:124``, host ``_mlp_bwd_call`` :260) is
``mp_mlp_bwd_tc`` in bf16 (one tensor-core tile computes everything per
pixel) and ``mp_mlp_bwd`` + ``csrc/grad.cu``'s ``ln_linear_bwd`` in float32,
both followed by grad.cu's weight products and partial sums. Plain versions:
:func:`mlp_plain`, :func:`mlp_bwd_plain`. Weights in torch Linear layout: w1
(2h, C), w2 (C, h).

Weight layouts at the launch: the forward (the tensor-core tail tile of
``csrc/mlp_tail.cuh``, also the spectral apply kernel's PGSSTB tail: bf16
``mlp_tail_tc``, float32 ``mlp_tail_f32`` in 3xTF32) and the bf16 backward
tile stream the packs of :func:`pack_mlp_weights` in the compute type, made
on every call; the float32 backward takes [in][out] copies. Every launch of
the float32 tile (here and in the float32 spectral apply with the tail)
also counts in ``TAIL_F32``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._grad import (
    ln_bwd_plain, ln_linear_bwd, ln_stats, sum_parts, wgrad,
)
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)

COUNTER = counter("mlp")
BWD = counter("mlp_bwd")
# the float32 tail tile (3xTF32), launched by this wrapper and by the float32
# spectral apply with the PGSSTB tail: ("mlp_tail_f32", B, H, W, C, hid)
TAIL_F32 = counter("mlp_tail_f32")
# the bf16 tail tile's hidden chunk and depth tile (kTailK of
# csrc/mlp_tail.cuh) and its widest C (kTailMaxC: fc2's output slice is held
# in registers)
TAIL_K = 64
TAIL_MAX_C = 384
# the bf16 backward tile's plan (MlpBwdPlan in csrc/mlp.cu): a ring stage's
# bytes (kTailStage: [128][TAIL_K + 8] bf16) and its most stages
# (kTailStages), the dh chunk's row (kBwdLdh) and the dynamic bytes a plan
# may take (kBwdBudget: the H100's opt-in limit less 1 KB)
TAIL_STAGE = 2 * 128 * (TAIL_K + 8)
TAIL_STAGES = 4
MLP_BWD_LDH = 2 * TAIL_K + 8
MLP_BWD_BUDGET = 232448 - 1024
# the float32 tail tile's plan (tail_f32_bytes in csrc/mlp_tail.cuh): rows of
# TAIL_K + 4 floats (kTailLdF), ring stages of [128][TAIL_LDF] float32
# (kTailStageF), the dynamic bytes a plan may take (kTailF32Budget)
TAIL_LDF = TAIL_K + 4
TAIL_STAGE_F32 = 4 * 128 * TAIL_LDF
TAIL_F32_BUDGET = 232448 - 1024


def _scale(dp_scale, b):
    return 1.0 if dp_scale is None else dp_scale.float().reshape(b, 1, 1, 1)


def mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, residual: bool = False, dp_scale=None,
              eps: float = 1e-5):
    dt = x.dtype
    hid = w2.shape[1]
    h = layer_norm(x, ln_w, ln_b, eps).float() @ w1.to(dt).float().t() + b1.float()
    gated = (h[..., :hid] * gelu_exact(h[..., hid:])).to(dt).float()
    br = ((gated @ w2.to(dt).float().t() + b2.float()) * _scale(dp_scale, x.shape[0])).to(dt)
    return (x.float() + br.float()).to(dt) if residual else br


def mlp_bwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, dp_scale, residual, eps, dy):
    """Explicit VJP of :func:`mlp_plain`: returns (dx, d ln_w, d ln_b, d w1,
    d b1, d w2, d b2, d dp_scale), parameter cotangents float32."""
    dt = x.dtype
    b, c = x.shape[0], x.shape[-1]
    hid = w2.shape[1]
    w1r, w2r = w1.to(dt).float(), w2.to(dt).float()
    xhat, rstd = ln_stats(x, eps)
    xn = layer_norm(x, ln_w, ln_b, eps).float()
    h = xn @ w1r.t() + b1.float()
    a, g = h[..., :hid], h[..., hid:]
    gelu_g = gelu_exact(g)
    gated = (a * gelu_g).to(dt).float()
    dyf = dy.float()
    ddp = None
    if dp_scale is not None:
        ddp = (dyf * (gated @ w2r.t() + b2.float())).sum(dim=(1, 2, 3)).to(dp_scale.dtype)
    dys = (dyf * _scale(dp_scale, b)).to(dt).float()
    dgated = dys @ w2r
    dw2 = dys.reshape(-1, c).t() @ gated.reshape(-1, hid)
    db2 = dys.sum(dim=(0, 1, 2))
    phi = torch.exp(-0.5 * g * g) * (2 * torch.pi) ** -0.5
    dgelu = 0.5 * (1 + torch.erf(g * 2 ** -0.5)) + g * phi
    dh = torch.cat([dgated * gelu_g, dgated * a * dgelu], dim=-1).to(dt).float()
    db1 = dh.sum(dim=(0, 1, 2))
    dw1 = dh.reshape(-1, 2 * hid).t() @ xn.reshape(-1, c)
    dx, dlnw, dlnb = ln_bwd_plain(dh @ w1r, xhat, rstd, ln_w)
    if residual:
        dx = dx + dyf
    return dx.to(dt), dlnw, dlnb, dw1, db1, dw2, db2, ddp


def _round_k(n: int) -> int:
    return -(-n // TAIL_K) * TAIL_K


@lru_cache(maxsize=32)
def _fc1_rows(hid: int, device: torch.device) -> torch.Tensor:
    """The packed fc1 row of each torch fc1 row: a-unit u (row u) at
    128 (u // 64) + 32 (u % 64 // 16) + u % 16 of the slab stack, its g-row
    (row hid + u) 16 further."""
    u = torch.arange(hid)
    a = u // TAIL_K * 128 + u % TAIL_K // 16 * 32 + u % 16
    return torch.cat([a, a + 16]).to(device)


def pack_mlp_weights(w1: torch.Tensor, w2: torch.Tensor, dt: torch.dtype):
    """(2h, C) fc1 and (C, h) fc2 torch-Linear weights -> the bf16 tail
    tile's streamed layouts in ``dt``: fc1 as [hP / 64][128][CK], one slab
    per 64-unit hidden chunk whose row 32 q + i (q < 4, i < 16) is a-unit
    16 q + i of the chunk and row 32 q + 16 + i the same unit's g-row; fc2
    as [CK][hP]. hP and CK are h and C rounded up to 64; every other entry
    is zero."""
    hid2, c = w1.shape
    hid = hid2 // 2
    ck, hp = _round_k(c), _round_k(hid)
    w1p = torch.zeros((hp // TAIL_K * 128, ck), dtype=dt, device=w1.device)
    w1p[_fc1_rows(hid, w1.device), :c] = w1.to(dt)
    w2p = torch.zeros((ck, hp), dtype=dt, device=w2.device)
    w2p[:c, :hid] = w2
    return w1p.reshape(hp // TAIL_K, 128, ck), w2p


def tail_f32_plan(c: int, hid: int = 0) -> dict:
    """The float32 tail tile's plan at width ``c`` and hidden width ``hid``
    (``tail_f32_bytes`` / ``tail_f32_stages`` in csrc/mlp_tail.cuh): ``ck`` =
    c rounded up to 64, ``ld`` = ck + 4 the LN2 row; ``ws`` ring stages (2 to
    4, as many as the budget holds); ``bytes`` = LN2 | the gated chunk | the
    ring (the mlp kernel's plan; the apply kernel's is the larger of it and
    its front's); per hidden chunk ``nk1`` fc1 tiles, then per output
    ``groups`` entry (first channel, fc2 tiles) that group's fc2 tiles, over
    ``nch`` chunks."""
    ck = _round_k(c)
    fixed = 4 * (64 * (ck + 4) + 64 * TAIL_LDF)
    ws = TAIL_STAGES
    while ws > 2 and fixed + ws * TAIL_STAGE_F32 > TAIL_F32_BUDGET:
        ws -= 1
    groups = [(n0, -(-min(TAIL_MAX_C, ck - n0) // 128)) for n0 in range(0, ck, TAIL_MAX_C)]
    return dict(ck=ck, ld=ck + 4, ws=ws, bytes=fixed + ws * TAIL_STAGE_F32, nk1=ck // TAIL_K,
                nch=-(-hid // TAIL_K), groups=groups)


def mlp_bwd_tc_plan(c: int, hid: int = 0) -> dict:
    """The bf16 backward tile's plan (``MlpBwdPlan`` in csrc/mlp.cu) at width
    ``c`` and hidden width ``hid``: ``ck`` = c rounded up to 64 and ``ld`` =
    ck + 8, the row of the x, dys and dy tiles; per hidden chunk ``nk1`` fc1
    slab tiles (64 deep), ``nk2`` fc2 tiles (128 channels), then the slab's
    ``nk1`` tiles again (``per`` in all), ``tiles`` over the ``nch`` chunks,
    through ``ws`` ring stages; ``bytes`` the dynamic shared memory (the three
    tiles, the dh chunk, the LN statistics, db1's column sums, the ring)."""
    ck = _round_k(c)
    ld = ck + 8
    fixed = 3 * 2 * 64 * ld + 2 * 64 * MLP_BWD_LDH + 4 * (2 * 64 + 4 * 2 * TAIL_K)
    ws = TAIL_STAGES
    while ws > 2 and fixed + ws * TAIL_STAGE > MLP_BWD_BUDGET:
        ws -= 1
    nk1, nk2, nch = ck // TAIL_K, -(-ck // 128), -(-hid // TAIL_K)
    per = 2 * nk1 + nk2
    return dict(ck=ck, ld=ld, nk1=nk1, nk2=nk2, per=per, nch=nch, tiles=nch * per, ws=ws,
                bytes=fixed + ws * TAIL_STAGE)


@lru_cache(maxsize=None)
def _entry(kind: str = "fwd"):
    if kind == "bwd_tc":
        return _build.entry("mp_mlp_bwd_tc", 16, [ctypes.c_int] * 6 + [ctypes.c_float])
    if kind == "bwd":
        return _build.entry("mp_mlp_bwd", 15, [ctypes.c_int] * 6 + [ctypes.c_float])
    return _build.entry("mp_mlp", 9, [ctypes.c_int] * 7 + [ctypes.c_float])


def check_tail_width(c: int, dt: torch.dtype) -> None:
    """ValueError where the bf16 tail tile cannot take width ``c``."""
    if dt == torch.bfloat16 and c > TAIL_MAX_C:
        raise ValueError(f"the bf16 tail MLP kernels take C up to {TAIL_MAX_C}, got {c}")


def _prepare(x, ln_w, ln_b, w1, b1, w2, b2, residual, dp_scale, eps):
    """Everything a launch needs: (the C entry's arguments, out, the tensors
    the arguments point into, to be held until the launch)."""
    b, h, w, c = x.shape
    if h % 8 or w % 8:
        raise ValueError(f"mlp needs H, W % 8 == 0, got {x.shape}")
    dt = x.dtype
    code = dtype_code(x)
    hid = w2.shape[1]
    check_tail_width(c, dt)
    _build.check_plan("mlp", "mp_mlp_smem", f"C={c}", c, code)
    x = x.contiguous()
    # every operand bound to a name until the launch: a temporary freed
    # mid-call could hand its memory to the next one
    lnw, lnb, b1f, b2f, dp = f32(ln_w), f32(ln_b), f32(b1), f32(b2), f32(dp_scale)
    w1k, w2k = pack_mlp_weights(w1, w2, dt)
    out = torch.empty_like(x)
    args = (x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1k.data_ptr(), b1f.data_ptr(),
            w2k.data_ptr(), b2f.data_ptr(), _build.ptr(dp), out.data_ptr(), code, b, h, w, c,
            hid, int(residual), eps, stream_ptr())
    return args, out, (x, lnw, lnb, b1f, b2f, dp, w1k, w2k)


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, residual, dp_scale, eps):
    args, out, _held = _prepare(x, ln_w, ln_b, w1, b1, w2, b2, residual, dp_scale, eps)
    _build.check("mp_mlp", _entry()(*args))
    b, h, w, c = x.shape
    COUNTER.record(("mlp", b, h, w, c, w2.shape[1], bool(residual), dp_scale is not None,
                    str(x.dtype)))
    if x.dtype == torch.float32:
        TAIL_F32.record(("mlp_tail_f32", b, h, w, c, w2.shape[1]))
    return out


def _bwd_tc_launch(x, ln_w, ln_b, w1, b1, w2, b2, dp_scale, residual, eps, dy):
    """The bf16 backward: the tile (everything per pixel), the two weight
    products, one in-order sum of the per-tile partials (and one of d s_b's
    per image)."""
    b, h, w, c = x.shape
    dt = x.dtype
    hid = w2.shape[1]
    check_tail_width(c, dt)
    _build.check_plan("mlp_bwd", "mp_mlp_bwd_tc_smem", f"C={c}", c)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    lnw, lnb, b1f, b2f, dp = f32(ln_w), f32(ln_b), f32(b1), f32(b2), f32(dp_scale)
    w1p, w2p = pack_mlp_weights(w1, w2, dt)
    dev = x.device
    tiles = (h // 8) * (w // 8)
    xn, dx = torch.empty_like(x), torch.empty_like(x)
    dys = dy if dp is None else torch.empty_like(x)  # without drop-path dys is dy
    dh = torch.empty((b, h, w, 2 * hid), dtype=dt, device=dev)
    gated = torch.empty((b, h, w, hid), dtype=dt, device=dev)
    part = torch.empty((1, b * tiles, 3 * c + 2 * hid), dtype=torch.float32, device=dev)
    pdp = torch.empty((b, tiles, 1), dtype=torch.float32, device=dev) if dp is not None else None
    p = _build.ptr
    err = _entry("bwd_tc")(x.data_ptr(), dy.data_ptr(), lnw.data_ptr(), lnb.data_ptr(),
                           w1p.data_ptr(), b1f.data_ptr(), w2p.data_ptr(), b2f.data_ptr(), p(dp),
                           xn.data_ptr(), dh.data_ptr(), gated.data_ptr(), dys.data_ptr(),
                           dx.data_ptr(), part.data_ptr(), p(pdp), b, h, w, c, hid,
                           int(residual), eps, stream_ptr())
    _build.check("mp_mlp_bwd_tc", err)
    dw1 = wgrad(xn.reshape(-1, c), dh.reshape(-1, 2 * hid)).t()
    dw2 = wgrad(gated.reshape(-1, hid), dys.reshape(-1, c)).t()
    dlnw, dlnb, db1, db2 = sum_parts(part)[0].split([c, c, 2 * hid, c])
    ddp = None if pdp is None else sum_parts(pdp)[:, 0].to(dp_scale.dtype)
    BWD.record(("mlp_bwd", b, h, w, c, hid, bool(residual), dp is not None, str(dt)))
    return dx, dlnw, dlnb, dw1, db1, dw2, db2, ddp


def _bwd_launch(x, ln_w, ln_b, w1, b1, w2, b2, dp_scale, residual, eps, dy):
    if x.dtype == torch.bfloat16:
        return _bwd_tc_launch(x, ln_w, ln_b, w1, b1, w2, b2, dp_scale, residual, eps, dy)
    b, h, w, c = x.shape
    dt = x.dtype
    hid = w2.shape[1]
    kc = _build.chunk("mp_mlp_bwd_chunk", c)
    _build.check_plan("mlp_bwd", "mp_mlp_bwd_smem", f"C={c}", c, kc)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    lnw, lnb, b1f, b2f, dp = f32(ln_w), f32(ln_b), f32(b1), f32(b2), f32(dp_scale)
    w1k, w2k = kernel_weight(w1, dt), kernel_weight(w2, dt)
    dev = x.device
    tiles = (h // 8) * (w // 8)
    xn, dys = torch.empty_like(x), torch.empty_like(x)
    dh = torch.empty((b, h, w, 2 * hid), dtype=dt, device=dev)
    gated = torch.empty((b, h, w, hid), dtype=dt, device=dev)
    pb2 = torch.empty((1, b * tiles, c), dtype=torch.float32, device=dev)
    pdp = torch.empty((b, tiles), dtype=torch.float32, device=dev) if dp is not None else None
    p = _build.ptr
    err = _entry("bwd")(x.data_ptr(), dy.data_ptr(), lnw.data_ptr(), lnb.data_ptr(),
                        w1k.data_ptr(), b1f.data_ptr(), w2k.data_ptr(),
                        b2f.data_ptr(), p(dp), xn.data_ptr(), dh.data_ptr(), gated.data_ptr(),
                        dys.data_ptr(), pb2.data_ptr(), p(pdp), b, h, w, c, hid, kc, eps,
                        stream_ptr())
    _build.check("mp_mlp_bwd", err)
    dx, (dlnw, dlnb), db1 = ln_linear_bwd(dh, w1k, 0, x, ln_w, extra_t=dy if residual else None,
                                          eps=eps, bias=True)
    dw1 = wgrad(xn.reshape(-1, c), dh.reshape(-1, 2 * hid)).t()
    dw2 = wgrad(gated.reshape(-1, hid), dys.reshape(-1, c)).t()
    db2 = sum_parts(pb2)[0]
    ddp = None if pdp is None else sum_parts(pdp.unsqueeze(-1))[:, 0].to(dp_scale.dtype)
    BWD.record(("mlp_bwd", b, h, w, c, hid, bool(residual), dp is not None, str(dt)))
    return dx, dlnw, dlnb, dw1, db1, dw2, db2, ddp


class _Mlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, dp_scale, cfg):
        residual, eps = cfg
        ctx.kernel = ROUTE.use_kernel(x)
        out = (_launch if ctx.kernel else mlp_plain)(x, ln_w, ln_b, w1, b1, w2, b2, residual,
                                                     dp_scale, eps)
        ctx.cfg = cfg
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, dp_scale)
        return out

    @staticmethod
    def backward(ctx, dy):
        x = ctx.saved_tensors[0]
        if ctx.kernel:
            fn = _bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = mlp_bwd_plain
        residual, eps = ctx.cfg
        return (*fn(*ctx.saved_tensors, residual, eps, dy.contiguous()), None)


def mlp(x, ln_w, ln_b, w1, b1, w2, b2, residual: bool = False, dp_scale=None,
        eps: float = 1e-5):
    """Same contract as :func:`mlp_plain`, differentiable; launches the CUDA
    kernels on a CUDA tensor. ``dp_scale`` (B,) float32 or None."""
    return _Mlp.apply(x, ln_w, ln_b, w1, b1, w2, b2, dp_scale, (bool(residual), eps))
