"""LayerNorm + GDFN (Restormer gated depthwise-conv FFN) over NHWC maps, with
an optional residual and an optional trailing 1x1 projection.

Kernel: ``csrc/gdfn.cu`` (replaces ``_gdfn_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:1274``; the backward replaces
``_gdfn_bwd_kernel``, ``mp_hsir_tpu/ops/pallas_vjp.py:342``). Plain
versions: :func:`gdfn_plain`, :func:`gdfn_bwd_plain`. Weights are conv
weights in OIHW: w_in (2h, C, 1, 1), w_dw (2h, 1, 3, 3), w_out (C, h, 1, 1),
proj_w (Co, C, 1, 1). The exit projection ``proj_w`` is eval-only (no
backward), as in JAX.

The bf16 forward runs the tensor-core tile ``gdfn_tc_kernel`` (C and Co up
to :data:`GDFN_MAX_C`): it streams the torch layouts of the weights as they
are (:func:`pack_gdfn`) in the tiles that :func:`gdfn_plan` describes. The
bf16 backward runs two tensor-core tiles on the same operands:
``mp_gdfn_bwd_tc`` (the forward tile's front, then dgated from the
project_out tiles read transposed and the cotangent dc at the depthwise
output) and ``mp_gdfn_dx_tc`` (``csrc/dwconv_dx.cuh`` with float32 t at K = 2
hid: the transposed stencil, dx through project_in and the LayerNorm, plus
dy with the residual), then the two weight products and the in-order sums
of the per-tile partials (:func:`gdfn_bwd_tc_plan` mirrors both plans). The
float32 forward runs the 3xTF32 tile ``gdfn_f32_kernel`` (the bf16 tile's
design on m16n8k8 with no rounding points; C and Co up to 384 with the exit
1x1, any C without it): it streams the float32 torch layouts
(:func:`pack_gdfn_f32`) and the halo's 32-channel chunks in the tiles that
:func:`gdfn_f32_plan` describes, its launches counted in :data:`F32_TILE`
too. The float32 backward keeps the chunked SIMT kernel (``mp_gdfn_bwd`` +
``csrc/grad.cu``'s depthwise and LayerNorm stages) on [in][out] weight
copies.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._grad import (
    dwconv3_bwd_plain, dwconv3_f32, dwconv_bwd, ln_bwd_plain, ln_linear_bwd, ln_stats, sum_parts,
    wgrad,
)
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.kernels.mlp import TAIL_K, TAIL_MAX_C
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    F32_K, F32_LD, FRONT_ROWS, STATS_BUDGET, dwconv_dx_plan,
)

COUNTER = counter("gdfn")
F32_TILE = counter("gdfn_f32")
BWD = counter("gdfn_bwd")
# the bf16 tile (csrc/gdfn.cu), which takes the tail tile's fc2 and the
# front's halo: its widest C and Co (kTailMaxC), the hidden chunk and the
# weight tiles' depth (kGdfnK = kTailK), a tile's output rows (kTailN) and
# bytes (kTailStage), the ring's most stages (kTailStages), the float32 t
# row (kGdfnLdt), the gated tile's row (kTailLdg), the halo rows (kFrontRows)
# and the dynamic bytes a plan may take (kGdfnBudget, the stats tile's too)
GDFN_MAX_C, GDFN_K, GDFN_ROWS, GDFN_BUDGET = TAIL_MAX_C, TAIL_K, FRONT_ROWS, STATS_BUDGET
GDFN_N = 128
GDFN_STAGE = 2 * GDFN_N * (GDFN_K + 8)
GDFN_STAGES = 4
GDFN_LDT = 2 * GDFN_K + 8
GDFN_LDG = GDFN_K + 8
# the float32 tile (gdfn_f32_kernel): its hidden chunk (kGdfnF32K), the t
# row (kGdfnF32Ldt), the gated and w_out tile row (kGdfnF32Ldg) and the
# kernel's static shared memory (the halo rows' sources); its halo chunks
# are the float32 stats and apply tiles' (F32_K channels, rows of F32_LD)
GDFN_F32_K = 64
GDFN_F32_LDT = 2 * GDFN_F32_K + 8
GDFN_F32_LDG = GDFN_F32_K + 4
GDFN_F32_STATIC = 448


def gdfn_plain(x, ln_w, ln_b, w_in, w_dw, w_out, residual: bool = False, proj_w=None,
               eps: float = 1e-5):
    dt = x.dtype
    c = x.shape[-1]
    hid = w_out.shape[1]
    t = layer_norm(x, ln_w, ln_b, eps).float() @ w_in.to(dt).float().reshape(2 * hid, c).t()
    t = dwconv3_f32(t, w_dw.to(dt))
    gated = (gelu_exact(t[..., :hid]) * t[..., hid:]).to(dt)
    y = gated.float() @ w_out.to(dt).float().reshape(c, hid).t()
    if residual:
        y = y + x.float()
    y = y.to(dt)
    if proj_w is not None:
        y = (y.float() @ proj_w.to(dt).float().reshape(proj_w.shape[0], c).t()).to(dt)
    return y


def gdfn_bwd_plain(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy):
    """Explicit VJP of :func:`gdfn_plain` without ``proj_w``: returns (dx,
    d ln_w, d ln_b, d w_in, d w_dw, d w_out), weight cotangents float32."""
    dt = x.dtype
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    win = w_in.to(dt).float().reshape(2 * hid, c)
    wout = w_out.to(dt).float().reshape(c, hid)
    xhat, rstd = ln_stats(x, eps)
    xn = layer_norm(x, ln_w, ln_b, eps).float()
    t = xn @ win.t()
    a = dwconv3_f32(t, w_dw.to(dt))
    a1, a2 = a[..., :hid], a[..., hid:]
    gated = (gelu_exact(a1) * a2).to(dt).float()
    dyf = dy.float()
    dg = dyf @ wout
    phi = torch.exp(-0.5 * a1 * a1) * (2 * torch.pi) ** -0.5
    dgelu = 0.5 * (1 + torch.erf(a1 * 2 ** -0.5)) + a1 * phi
    da = torch.cat([dg * a2 * dgelu, dg * gelu_exact(a1)], dim=-1)
    dtt, dwdw = dwconv3_bwd_plain(da, t, w_dw.to(dt))
    dtt = dtt.to(dt).float()
    dw_in = dtt.reshape(-1, 2 * hid).t() @ xn.reshape(-1, c)
    dw_out = dyf.reshape(-1, c).t() @ gated.reshape(-1, hid)
    dx, dlnw, dlnb = ln_bwd_plain(dtt @ win, xhat, rstd, ln_w)
    if residual:
        dx = dx + dyf
    return (dx.to(dt), dlnw, dlnb, dw_in.reshape(2 * hid, c, 1, 1), dwdw,
            dw_out.reshape(c, hid, 1, 1))


def gdfn_plan(c: int, hid: int, co: int = 0) -> dict:
    """The bf16 tile's tiling (``GdfnPlan`` in csrc/gdfn.cu) at width ``c``,
    hidden width ``hid`` and exit width ``co`` (0: no exit 1x1): ``cp`` = c
    rounded up to 32, ``ld`` the halo's row; ``nch`` hidden chunks of
    :data:`GDFN_K` units, each ``nk`` project_in tiles (64 deep over cp) and
    ``nk2`` project_out tiles (128 output channels over c rounded up to 64);
    then ``npb`` x ``nk`` exit tiles; ``tiles`` in all through ``ws`` ring
    stages; ``bytes`` the dynamic shared memory (taps, gated tile, float32 t,
    halo, ring)."""
    cp = -(-c // 32) * 32
    ld = cp + 8
    nk, nch = -(-cp // GDFN_K), -(-hid // GDFN_K)
    nk2, npb = -(-(-(-c // 64) * 64) // GDFN_N), -(-co // GDFN_N)
    fixed = 4 * 9 * 2 * GDFN_K + 2 * 64 * GDFN_LDG + 4 * 100 * GDFN_LDT + 2 * GDFN_ROWS * ld
    ws = GDFN_STAGES
    while ws > 2 and fixed + ws * GDFN_STAGE > GDFN_BUDGET:
        ws -= 1
    return dict(cp=cp, ld=ld, nk=nk, nch=nch, nk2=nk2, npb=npb, ws=ws,
                tiles=nch * (nk + nk2) + npb * nk, bytes=fixed + ws * GDFN_STAGE)


def gdfn_bwd_tc_plan(c: int, hid: int) -> dict:
    """The bf16 backward's plans at width ``c``: tile 1's (``GdfnBwdPlan`` in
    csrc/gdfn.cu: :func:`gdfn_plan`'s tiling without the exit; ``bytes`` =
    float32 t [100][:data:`GDFN_LDT`] | halo [112][``ld``] | dy [64][``ld``] |
    ``ws`` ring stages, at most 4; the taps are read from device memory) and
    tile 2's at K = 2 ``hid`` (``dx``: :func:`dwconv_dx_plan` with float32
    t)."""
    pl = gdfn_plan(c, hid)
    fixed = 4 * 100 * GDFN_LDT + 2 * GDFN_ROWS * pl["ld"] + 2 * 64 * pl["ld"]
    ws = GDFN_STAGES
    while ws > 2 and fixed + ws * GDFN_STAGE > GDFN_BUDGET:
        ws -= 1
    return dict(cp=pl["cp"], ld=pl["ld"], nk=pl["nk"], nch=pl["nch"], nk2=pl["nk2"], ws=ws,
                tiles=pl["nch"] * (pl["nk"] + pl["nk2"]), bytes=fixed + ws * GDFN_STAGE,
                dx=dwconv_dx_plan(c, 2 * hid, f32_t=True))


def gdfn_f32_plan(c: int, co: int = 0) -> dict:
    """The float32 tile's tiling (``GdfnF32Plan`` in csrc/gdfn.cu) at width
    ``c`` and exit width ``co`` (0: no exit 1x1): ``cp`` = c rounded up to
    32, ``nk`` halo chunks of ``F32_K`` (32) channels per project_in pass
    (two a hidden chunk of :data:`GDFN_F32_K` units: its x1 units, then its
    x2 units); ``stage`` the ring's stage (a halo chunk beside the pass's 64
    rows of w_in, or a [128][68] w_out tile), ``ws`` stages; ``bytes`` the
    dynamic shared memory (taps, LN mean and rstd, gated tile, float32 t,
    ring) and ``smem`` with the static (what ``mp_gdfn_f32_smem(c)``
    returns); the exit's y [64][``ldy``] and its ``cs`` stages of proj_w's
    [``np``][36] chunks over the dead front (``exit`` bytes), within
    ``bytes``."""
    cp = -(-c // 32) * 32
    fixed = 4 * (9 * 2 * GDFN_F32_K + 2 * GDFN_ROWS + 64 * GDFN_F32_LDG + 100 * GDFN_F32_LDT)
    stage = max(4 * (GDFN_ROWS + GDFN_F32_K) * F32_LD, 4 * GDFN_N * GDFN_F32_LDG)
    ws = 4
    while ws > 2 and fixed + ws * stage > GDFN_BUDGET:
        ws -= 1
    total = fixed + ws * stage
    np_, ldy = -(-co // 32) * 32, cp + 4
    cs = 3 if 4 * 64 * ldy + 3 * 4 * np_ * F32_LD <= total else 2
    return dict(cp=cp, nk=cp // F32_K, stage=stage, ws=ws, np=np_, ldy=ldy, cs=cs,
                exit=4 * 64 * ldy + cs * 4 * np_ * F32_LD if co else 0, bytes=total,
                smem=total + GDFN_F32_STATIC)


def pack_gdfn(w_in, w_dw, w_out, proj_w, dt, mult: int = 8):
    """The operands the bf16 tile streams, in ``dt``, in their torch layouts:
    w_in as [2 hid][C8], the depthwise taps as [2 hid][9], w_out as [C][hid8]
    and proj_w as [Co][C8] (or None); C8 and hid8 are C and hid rounded up
    to ``mult`` (8), the rows padded with zeros only where they are not
    multiples of it (16-byte rows for the kernel's copies). Views of the
    weights where they are already in ``dt`` and need no padding."""
    c, hid = w_out.shape[0], w_out.shape[1]

    def rows(w, n):
        w = w.reshape(w.shape[0], n).to(dt)
        return (F.pad(w, (0, -n % mult)) if n % mult else w).contiguous()

    wp = None if proj_w is None else rows(proj_w, c)
    return rows(w_in, c), w_dw.reshape(2 * hid, 9).to(dt).contiguous(), rows(w_out, hid), wp


def pack_gdfn_f32(w_in, w_dw, w_out, proj_w):
    """The operands the float32 tile streams: :func:`pack_gdfn`'s layouts in
    float32 with the rows padded to a multiple of 4 (16-byte rows): w_in
    [2 hid][C4], taps [2 hid][9], w_out [C][hid4], proj_w [Co][C4] (or
    None)."""
    return pack_gdfn(w_in, w_dw, w_out, proj_w, torch.float32, 4)


@lru_cache(maxsize=None)
def _entry(kind: str = "fwd"):
    import ctypes

    if kind == "bwd":
        return _build.entry("mp_gdfn_bwd", 11, [ctypes.c_int] * 7 + [ctypes.c_float])
    if kind == "bwd_tc":
        return _build.entry("mp_gdfn_bwd_tc", 11, [ctypes.c_int] * 5 + [ctypes.c_float])
    if kind == "dx_tc":
        return _build.entry("mp_gdfn_dx_tc", 10, [ctypes.c_int] * 5 + [ctypes.c_float])
    return _build.entry("mp_gdfn", 8, [ctypes.c_int] * 9 + [ctypes.c_float])


def _prepare(x, ln_w, ln_b, w_in, w_dw, w_out, residual=False, proj_w=None, eps=1e-5):
    """Everything a launch needs: (the C entry's arguments, out, the tensors
    the arguments point into, to be held until the launch). Weights: bf16
    :func:`pack_gdfn`, float32 :func:`pack_gdfn_f32`."""
    b, h, w, c = x.shape
    if h % 8 or w % 8:
        raise ValueError(f"gdfn needs H, W % 8 == 0, got {x.shape}")
    dt, code = x.dtype, dtype_code(x)
    hid = w_out.shape[1]
    co = c if proj_w is None else proj_w.shape[0]
    if code:
        if max(c, co) > GDFN_MAX_C:  # the widest C (and Co) of the tile's plan
            raise ValueError(f"the bf16 gdfn kernel takes C and Co up to {GDFN_MAX_C}, got "
                             f"C={c}, Co={co}")
        _build.check_plan("gdfn", "mp_gdfn_tc_smem", f"C={c}", c)
        wi, wd, wo, wp = pack_gdfn(w_in, w_dw, w_out, proj_w, dt)
    else:
        if proj_w is not None and max(c, co) > GDFN_MAX_C:  # y and the exit's one pass
            raise ValueError(f"the float32 gdfn kernel takes C and Co up to {GDFN_MAX_C} "
                             f"with proj_w, got C={c}, Co={co}")
        _build.check_plan("gdfn", "mp_gdfn_f32_smem", f"C={c}", c)
        wi, wd, wo, wp = pack_gdfn_f32(w_in, w_dw, w_out, proj_w)
    x = x.contiguous()
    lnw, lnb = f32(ln_w), f32(ln_b)
    out = torch.empty((b, h, w, co), dtype=dt, device=x.device)
    args = (x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wi.data_ptr(), wd.data_ptr(),
            wo.data_ptr(), _build.ptr(wp), out.data_ptr(), code, b, h, w, c, hid, co,
            int(residual), c, eps, stream_ptr())
    return args, out, (x, lnw, lnb, wi, wd, wo, wp)


def _launch(x, ln_w, ln_b, w_in, w_dw, w_out, residual, proj_w, eps):
    args, out, _held = _prepare(x, ln_w, ln_b, w_in, w_dw, w_out, residual, proj_w, eps)
    _build.check("mp_gdfn", _entry()(*args))
    b, h, w, c = x.shape
    spec = ("gdfn", b, h, w, c, w_out.shape[1], out.shape[-1], bool(residual))
    COUNTER.record(spec + (str(x.dtype),))
    if x.dtype == torch.float32:
        F32_TILE.record(("gdfn_f32",) + spec[1:])
    return out


def _bwd_tc_launch(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy):
    """The bf16 backward: the two tiles, the two weight products and the
    in-order sums of the per-tile partial rows (the taps' [9][2 hid], then d
    ln_w, d ln_b): per image over its tiles, then over the images."""
    b, h, w, c = x.shape
    dt = x.dtype
    hid = w_out.shape[1]
    k = 2 * hid
    if c > GDFN_MAX_C:  # the widest C of both tiles' plans
        raise ValueError(f"the bf16 gdfn backward takes C up to {GDFN_MAX_C}, got C={c}")
    _build.check_plan("gdfn_bwd", "mp_gdfn_bwd_tc_smem", f"C={c}, tile 1", c)
    _build.check_plan("gdfn_bwd", "mp_gdfn_dx_tc_smem", f"C={c}, tile 2", c)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    wi, wd, wo, _ = pack_gdfn(w_in, w_dw, w_out, None, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dev = x.device
    xn, dx = torch.empty_like(x), torch.empty_like(x)
    t = torch.empty((b, h, w, k), dtype=torch.float32, device=dev)
    dc = torch.empty_like(t)
    gated = torch.empty((b, h, w, hid), dtype=dt, device=dev)
    dtt = torch.empty((b, h, w, k), dtype=dt, device=dev)
    part = torch.empty((b, (h // 8) * (w // 8), 9 * k + 2 * c), dtype=torch.float32, device=dev)
    extra = dy.float() if residual else None
    err = _entry("bwd_tc")(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wi.data_ptr(),
                           wd.data_ptr(), wo.data_ptr(), dy.data_ptr(), xn.data_ptr(),
                           t.data_ptr(), dc.data_ptr(), gated.data_ptr(), b, h, w, c, hid, eps,
                           stream_ptr())
    _build.check("mp_gdfn_bwd_tc", err)
    err = _entry("dx_tc")(dc.data_ptr(), t.data_ptr(), wd.data_ptr(), wi.data_ptr(), x.data_ptr(),
                          lnw.data_ptr(), _build.ptr(extra), dtt.data_ptr(), dx.data_ptr(),
                          part.data_ptr(), b, h, w, c, hid, eps, stream_ptr())
    _build.check("mp_gdfn_dx_tc", err)
    dw_in = wgrad(xn.reshape(-1, c), dtt.reshape(-1, k)).t()
    dw_out = wgrad(gated.reshape(-1, hid), dy.reshape(-1, c)).t()
    sums = sum_parts(sum_parts(part).unsqueeze(0))[0]
    BWD.record(("gdfn_bwd", b, h, w, c, hid, bool(residual), str(dt)))
    return (dx, sums[9 * k:9 * k + c], sums[9 * k + c:], dw_in.reshape(k, c, 1, 1),
            sums[:9 * k].reshape(9, k).t().reshape(k, 1, 3, 3), dw_out.reshape(c, hid, 1, 1))


def _bwd_launch(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy):
    if x.dtype == torch.bfloat16:
        return _bwd_tc_launch(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy)
    b, h, w, c = x.shape
    dt = x.dtype
    hid = w_out.shape[1]
    kc = _build.chunk("mp_gdfn_bwd_chunk", c)
    _build.check_plan("gdfn_bwd", "mp_gdfn_bwd_smem", f"C={c}", c, kc)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    wi, wd, wo = kernel_weight(w_in, dt), kernel_weight(w_dw, dt), kernel_weight(w_out, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dev = x.device
    xn = torch.empty_like(x)
    t = torch.empty((b, h, w, 2 * hid), dtype=torch.float32, device=dev)
    dc = torch.empty_like(t)
    gated = torch.empty((b, h, w, hid), dtype=dt, device=dev)
    err = _entry("bwd")(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wi.data_ptr(), wd.data_ptr(),
                        wo.data_ptr(), dy.data_ptr(), xn.data_ptr(), t.data_ptr(), dc.data_ptr(),
                        gated.data_ptr(), dtype_code(x), b, h, w, c, hid, kc, eps, stream_ptr())
    _build.check("mp_gdfn_bwd", err)
    dtt, dwdw = dwconv_bwd(dc, t, wd, 0, dt)
    dx, (dlnw, dlnb), _ = ln_linear_bwd(dtt, wi, 0, x, ln_w, extra_t=dy if residual else None,
                                        eps=eps)
    dw_in = wgrad(xn.reshape(-1, c), dtt.reshape(-1, 2 * hid)).t()
    dw_out = wgrad(gated.reshape(-1, hid), dy.reshape(-1, c)).t()
    BWD.record(("gdfn_bwd", b, h, w, c, hid, bool(residual), str(dt)))
    return (dx, dlnw, dlnb, dw_in.reshape(2 * hid, c, 1, 1), dwdw.t().reshape(2 * hid, 1, 3, 3),
            dw_out.reshape(c, hid, 1, 1))


class _Gdfn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_in, w_dw, w_out, proj_w, cfg):
        residual, eps = cfg
        ctx.kernel = ROUTE.use_kernel(x)
        out = (_launch if ctx.kernel else gdfn_plain)(x, ln_w, ln_b, w_in, w_dw, w_out, residual,
                                                      proj_w, eps)
        ctx.cfg = cfg
        ctx.has_proj = proj_w is not None
        ctx.save_for_backward(x, ln_w, ln_b, w_in, w_dw, w_out)
        return out

    @staticmethod
    def backward(ctx, dy):
        if ctx.has_proj:
            raise RuntimeError("gdfn: no backward for the eval-only exit projection proj_w "
                               "(the training route applies PromptFusion's 1x1 conv outside)")
        x = ctx.saved_tensors[0]
        if ctx.kernel:
            fn = _bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = gdfn_bwd_plain
        return (*fn(*ctx.saved_tensors, *ctx.cfg, dy.contiguous()), None, None)


def gdfn(x, ln_w, ln_b, w_in, w_dw, w_out, residual: bool = False, proj_w=None,
         eps: float = 1e-5):
    """Same contract as :func:`gdfn_plain`, differentiable without
    ``proj_w``; launches the CUDA kernels on a CUDA tensor."""
    return _Gdfn.apply(x, ln_w, ln_b, w_in, w_dw, w_out, proj_w, (bool(residual), eps))
