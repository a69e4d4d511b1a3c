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
the two phases of ``_spectral_bwd_kernel`` (``:953``). The bf16 stats
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
``mp_spectral_gate_grad``, the two weight products and the in-order sums of
the per-tile partials (:func:`apply_bwd_tc_plan` mirrors both plans). The
eval-only options (``x2``, the ``mlp`` tail) have no backward, as in the JAX
package; a backward through them raises.

Layouts at these functions: NHWC maps; wqkv (3C, C, 1, 1) and wdw
(3C, 1, 3, 3) conv weights; the optional second input ``x2`` makes the
logical input ``cat([x, x2], -1)``; ``shift`` > 0 means ``x`` is in the
rolled frame of a shifted block and is read through the roll-back.

The stats launch runs a tensor-core tile in both types: bf16 the tile of
``csrc/spectral_stats.cuh`` (C up to :data:`FRONT_MAX_C`), float32 the 3xTF32
tile of ``csrc/spectral_stats_f32.cuh`` (heads up to 96 wide; its launches
counted in :data:`F32_TILE` too). Both stream the q|k rows of the torch
weights as they are (:func:`pack_stats`), in the head groups that
:func:`stats_plan` and :func:`stats_f32_plan` describe, and sum their per-part
partials in one more launch. The bf16 apply launch runs the tensor-core tile of
``csrc/spectral_front.cuh`` (C up to :data:`FRONT_MAX_C`): it streams the v
rows of the torch weights and a bf16 copy of ``comb`` as they are
(:func:`pack_front`), in the tiles that :func:`front_plan` describes. The
float32 apply launch keeps its SIMT front; its PGSSTB tail runs the float32
tail tile of ``csrc/mlp_tail.cuh`` (3xTF32 on the tensor cores, any C whose
plan fits) on :func:`~mp_hsir_tpu_torch.ops.kernels.mlp.pack_mlp_weights`'
float32 packs, counted in ``mlp.TAIL_F32`` too.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._grad import (
    dwconv3_bwd_plain, dwconv3_f32, dwconv_bwd, grad_or_zeros, ln_bwd_plain, ln_linear_bwd,
    ln_stats, sum_parts, wgrad,
)
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.kernels.mlp import TAIL_F32, pack_mlp_weights
from mp_hsir_tpu_torch.ops.window import roll_hw

STATS = counter("spectral_stats")
F32_TILE = counter("spectral_stats_f32")
APPLY = counter("spectral_apply")
STATS_BWD = counter("spectral_stats_bwd")
APPLY_BWD = counter("spectral_apply_bwd")
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
# the bf16 backward's second tile (csrc/dwconv_dx.cuh): the row strides of
# its dout (float32) and t / dt (bf16) chunks (kDxLdd, kDxLdt)
DX_LDD = 68
DX_LDT = 72

__all__ = ["dwconv3_f32", "spectral_stats", "spectral_apply", "spectral_fold"]


def _input(x, x2, shift, ln_w, ln_b, eps):
    """(raw, normalised) logical input in the unrolled frame."""
    u = roll_hw(x, shift, shift) if shift else x
    if x2 is not None:
        u = torch.cat([u, x2], dim=-1)
    return u, (layer_norm(u, ln_w, ln_b, eps) if ln_w is not None else u)


def _qkv_part(u, wqkv, wdw, lo, hi, dt):
    """(t, dw3x3(t)) with t = 1x1(u)[..., lo:hi], rounded to dt where the
    kernels round (float32 tensors of dt values)."""
    c = u.shape[-1]
    t = (u.float() @ wqkv[lo:hi].reshape(hi - lo, c).to(dt).float().t()).to(dt).float()
    return t, dwconv3_f32(t, wdw[lo:hi].to(dt)).to(dt).float()


def _no_eval_only_grad(name, **opts):
    bad = [k for k, v in opts.items() if v is not None]
    if bad:
        raise RuntimeError(f"{name}: no backward for the eval-only option(s) {bad} "
                           "(the training route runs without them, as in the JAX package)")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def spectral_stats_plain(x, wqkv, wdw, num_heads: int, shift: int = 0, x2=None,
                         ln_w=None, ln_b=None, eps: float = 1e-5):
    """Returns (gram (B, C, dh), nq (B, nH, dh), nk (B, nH, dh)), float32."""
    _, u = _input(x, x2, shift, ln_w, ln_b, eps)
    b, h, w, c = u.shape
    dh = c // num_heads
    qk = _qkv_part(u, wqkv, wdw, 0, 2 * c, x.dtype)[1].reshape(b, h * w, 2, num_heads, dh)
    q, k = qk[:, :, 0], qk[:, :, 1]
    gram = torch.einsum("bphd,bphe->bhde", q, k).reshape(b, c, dh)
    return gram, q.square().sum(dim=1), k.square().sum(dim=1)


def spectral_stats_bwd_plain(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk):
    """Explicit VJP of :func:`spectral_stats_plain` (one input): returns
    (dx, d wqkv, d wdw, d ln_w, d ln_b); the v sections of the weight
    cotangents are zero."""
    dt = x.dtype
    raw, u = _input(x, None, shift, ln_w, ln_b, eps)
    b, h, w, c = u.shape
    dh = c // num_heads
    wqk = wqkv[:2 * c].reshape(2 * c, c).to(dt).float()
    t, qk = _qkv_part(u, wqkv, wdw, 0, 2 * c, dt)
    q = qk[..., :c].reshape(b, h, w, num_heads, dh)
    k = qk[..., c:].reshape(b, h, w, num_heads, dh)
    dg = dgram.to(dt).float().reshape(b, num_heads, dh, dh)
    dq = torch.einsum("byxne,bnde->byxnd", k, dg) + 2 * q * dnq.reshape(b, 1, 1, num_heads, dh)
    dk = torch.einsum("byxnd,bnde->byxne", q, dg) + 2 * k * dnk.reshape(b, 1, 1, num_heads, dh)
    dqk = torch.cat([dq.reshape(b, h, w, c), dk.reshape(b, h, w, c)], dim=-1)
    dtt, dwdw_qk = dwconv3_bwd_plain(dqk, t, wdw[:2 * c].to(dt))
    dtt = dtt.to(dt).float()
    dw = torch.zeros((3 * c, c), dtype=torch.float32, device=x.device)
    dw[:2 * c] = dtt.reshape(-1, 2 * c).t() @ u.float().reshape(-1, c)
    dwdw = torch.zeros((3 * c, 1, 3, 3), dtype=torch.float32, device=x.device)
    dwdw[:2 * c] = dwdw_qk
    du = dtt @ wqk
    dlnw = dlnb = None
    if ln_w is not None:
        du, dlnw, dlnb = ln_bwd_plain(du, *ln_stats(raw, eps), ln_w)
    dx = roll_hw(du, -shift, -shift) if shift else du
    return dx.to(dt), dw.reshape(3 * c, c, 1, 1), dwdw, dlnw, dlnb


def stats_plan(c: int, heads: int) -> dict:
    """The bf16 stats tile's tiling at width ``c`` (``StatsPlan`` in
    csrc/spectral_stats.cuh): the output columns ordered by head, each head
    ``hw`` = 2 ``dhp`` wide (q, then k, dh padded to ``dhp``, a multiple of
    16), in ``groups`` groups of ``hg`` heads (``gw`` columns), each group's
    1x1 in passes of ``np`` columns over ``nk`` 64-deep weight tiles and ``ws``
    ring stages; ``cp`` = c rounded up to 32; ``bytes`` the dynamic shared
    memory."""
    dh = c // heads
    dhp = -(-dh // 16) * 16
    hw, cp = 2 * dhp, -(-c // 32) * 32
    nqk = heads * hw
    fixed = 2 * 9 * nqk + 4 * heads * dhp * dhp + 4 * nqk + 2 * FRONT_ROWS * (cp + 8)
    hmax = max(1, STATS_MAX_N // hw)
    while True:
        groups = -(-heads // hmax)
        hg = -(-heads // groups)
        gw = hg * hw
        pp = -(-gw // STATS_MAX_N)
        np_ = 32 * -(-(gw // 32) // pp)
        for ws in (3, 2):
            nbytes = fixed + 2 * 64 * (gw + 8) + max(2 * ws * np_ * 72, 2 * 100 * (np_ + 8))
            if nbytes <= STATS_BUDGET:
                break
        if nbytes <= STATS_BUDGET or hmax == 1:
            break
        hmax -= 1
    return dict(dh=dh, dhp=dhp, hw=hw, nqk=nqk, cp=cp, nk=-(-cp // FRONT_K), hg=hg,
                groups=groups, gw=gw, np=np_, ws=ws, bytes=nbytes)


def stats_f32_plan(c: int, heads: int) -> dict:
    """The float32 stats tile's tiling at width ``c`` (``StatsF32Plan`` in
    csrc/spectral_stats_f32.cuh): the head-grouped columns of
    :func:`stats_plan` (``dhp``, ``hw``, ``nqk``) in ``groups`` groups of
    ``hg`` heads (``gw`` columns), the K chunks ``nk`` of :data:`F32_K`
    channels, ``ws`` ring stages; ``dyn`` the dynamic shared memory and
    ``bytes`` the plan with the static (what ``mp_spectral_stats_smem``
    returns). ``ok``: a head's columns fit one group (dh up to 96)."""
    dh = c // heads
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


def stats_bwd_tc_plan(c: int, heads: int) -> dict:
    """The bf16 stats backward's plans: the first tile's (``StatsBwdPlan``
    in csrc/spectral_stats.cuh: :func:`stats_plan`'s tiling with dG, bf16
    [heads][dhp][``ldg`` = dhp + 8], in the place of the Gram partial;
    ``bytes``) and the second tile's at K = 2C (``dx``: :func:`dwconv_dx_plan`)."""
    pl = stats_plan(c, heads)
    ldg = pl["dhp"] + 8
    dg = 2 * heads * pl["dhp"] * ldg
    return dict(pl, ldg=ldg, bytes=pl["bytes"] - 4 * heads * pl["dhp"] ** 2 + dg,
                dx=dwconv_dx_plan(c, 2 * c))


def qk_row(n: int, plan: dict, c: int) -> int:
    """The row of :func:`pack_stats`' q|k weights behind column ``n`` of the
    tile's head-grouped order (``qk_row`` in csrc/spectral_stats.cuh), or -1
    for a padding column."""
    h, j = divmod(n, plan["hw"])
    d = j if j < plan["dhp"] else j - plan["dhp"]
    return (0 if j < plan["dhp"] else c) + h * plan["dh"] + d if d < plan["dh"] else -1


def pack_stats(wqkv, wdw, dt):
    """The operands the stats tiles stream, in ``dt``: the q|k rows of the
    1x1 weight as [2C out][C8 in] (torch layout) and their depthwise taps
    as [2C][9]; C8 is C rounded up to 8, the rows padded with zeros only
    where C is not a multiple of 8 (rows of whole 16-byte vectors for the
    kernels' copies in both types). Views of the weights where they are
    already in ``dt``."""
    c = wqkv.shape[1]
    wqk = wqkv[:2 * c].reshape(2 * c, c).to(dt)
    if c % 8:
        wqk = F.pad(wqk, (0, -c % 8))
    return wqk.contiguous(), wdw[:2 * c].reshape(2 * c, 9).to(dt).contiguous()


@lru_cache(maxsize=None)
def _stats_entry(kind: str = "fwd"):
    import ctypes

    if kind == "bwd":
        return _build.entry("mp_spectral_stats_bwd", 11, [ctypes.c_int] * 6 + [ctypes.c_float])
    if kind == "bwd_tc":
        return _build.entry("mp_spectral_stats_bwd_tc", 11, [ctypes.c_int] * 6 + [ctypes.c_float])
    if kind == "dx_tc":
        return _build.entry("mp_dwconv_dx_tc", 9, [ctypes.c_int] * 6 + [ctypes.c_float])
    return _build.entry("mp_spectral_stats", 10,
                        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int])


@lru_cache(maxsize=None)
def _stats_parts(*shape: int) -> int:
    """The parts per image of a stats launch (``mp_spectral_stats_parts``:
    dtype, B, H, W, C, heads), asked once per shape."""
    import ctypes

    fn = _build.lib().mp_spectral_stats_parts
    fn.argtypes, fn.restype = [ctypes.c_int] * len(shape), ctypes.c_int
    n = int(fn(*shape))
    if n <= 0:
        raise RuntimeError(f"mp_spectral_stats_parts{shape} failed")
    return n


def _stats_prepare(x, wqkv, wdw, num_heads, shift=0, x2=None, ln_w=None, ln_b=None, eps=1e-5):
    """Everything a launch needs: (the C entry's arguments, the outputs, the
    tensors the arguments point into, to be held until the launch). Weights:
    :func:`pack_stats` in the compute type."""
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    c = c1 + c2
    if h % 8 or w % 8 or c % num_heads:
        raise ValueError(f"spectral stats needs H, W % 8 == 0 and C % heads == 0, got {x.shape}")
    dt, code = x.dtype, dtype_code(x)
    dh = c // num_heads
    what = f"C={c}, heads={num_heads}"
    if code:
        if c > FRONT_MAX_C:  # the widest C of the tile's plan
            raise ValueError(f"the bf16 spectral stats kernel takes C up to {FRONT_MAX_C}, got {c}")
        _build.check_plan("spectral_stats", "mp_spectral_stats_tc_smem", what, c, num_heads)
    else:
        if not stats_f32_plan(c, num_heads)["ok"]:  # a head's columns in one group
            raise ValueError(f"the float32 spectral stats kernel takes heads up to 96 wide, "
                             f"got {dh}")
        _build.check_plan("spectral_stats", "mp_spectral_stats_smem", what, c, num_heads)
    wq, wd = pack_stats(wqkv, wdw, dt)
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    lnw, lnb = f32(ln_w), f32(ln_b)
    n_parts = _stats_parts(code, b, h, w, c, num_heads)
    dev = x.device
    part = torch.empty((b, n_parts, c * dh + 2 * c), dtype=torch.float32, device=dev)
    gram = torch.empty((b, c, dh), dtype=torch.float32, device=dev)
    nq = torch.empty((b, num_heads, dh), dtype=torch.float32, device=dev)
    nk = torch.empty_like(nq)
    p = _build.ptr
    args = (x.data_ptr(), p(x2), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(), part.data_ptr(),
            gram.data_ptr(), nq.data_ptr(), nk.data_ptr(), code, b, h, w, c1, c2, num_heads,
            shift, eps, n_parts, stream_ptr())
    return args, (gram, nq, nk), (x, x2, lnw, lnb, wq, wd, part)


def _stats_launch(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps):
    args, out, _held = _stats_prepare(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps)
    _build.check("mp_spectral_stats", _stats_entry()(*args))
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    ln = ln_w is not None
    STATS.record(("spectral_stats", b, h, w, c1, c2, num_heads, shift, ln, str(x.dtype)))
    if x.dtype == torch.float32:
        F32_TILE.record(("spectral_stats_f32", b, h, w, c1, c2, num_heads, shift, ln))
    return out


def _stats_bwd_tc_launch(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk):
    """The bf16 backward: the two tiles, the weight product and one in-order
    sum of the per-tile partials (the taps' [9][2C], then d ln_w, d ln_b)."""
    b, h, w, c = x.shape
    dt = x.dtype
    if c > FRONT_MAX_C:  # the widest C of both tiles' plans
        raise ValueError(f"the bf16 spectral stats backward takes C up to {FRONT_MAX_C}, got {c}")
    what = f"C={c}, heads={num_heads}"
    _build.check_plan("spectral_stats_bwd", "mp_spectral_stats_bwd_tc_smem", what, c, num_heads)
    _build.check_plan("spectral_stats_bwd", "mp_dwconv_dx_tc_smem", what, c, 2 * c)
    x = x.contiguous()
    wq, wd = pack_stats(wqkv, wdw, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dgram, dnq, dnk = f32(dgram), f32(dnq), f32(dnk)
    dev = x.device
    tiles = b * (h // 8) * (w // 8)
    un = torch.empty((b, h, w, c), dtype=dt, device=dev)
    t = torch.empty((b, h, w, 2 * c), dtype=dt, device=dev)
    dqk = torch.empty((b, h, w, 2 * c), dtype=torch.float32, device=dev)
    dtt, dx = torch.empty_like(t), torch.empty_like(x)
    ln = lnw is not None
    part = torch.empty((1, tiles, 18 * c + (2 * c if ln else 0)), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _stats_entry("bwd_tc")(x.data_ptr(), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(),
                                 dgram.data_ptr(), dnq.data_ptr(), dnk.data_ptr(), un.data_ptr(),
                                 t.data_ptr(), dqk.data_ptr(), b, h, w, c, num_heads, shift, eps,
                                 stream_ptr())
    _build.check("mp_spectral_stats_bwd_tc", err)
    err = _stats_entry("dx_tc")(dqk.data_ptr(), t.data_ptr(), wd.data_ptr(), wq.data_ptr(),
                                x.data_ptr(), p(lnw), dtt.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), b, h, w, c, 2 * c, shift, eps, stream_ptr())
    _build.check("mp_dwconv_dx_tc", err)
    dw = torch.zeros((3 * c, c), dtype=torch.float32, device=dev)
    dw[:2 * c] = wgrad(un.reshape(-1, c), dtt.reshape(-1, 2 * c)).t()
    sums = sum_parts(part)[0]
    dwdw = torch.zeros((3 * c, 9), dtype=torch.float32, device=dev)
    dwdw[:2 * c] = sums[:18 * c].reshape(9, 2 * c).t()
    STATS_BWD.record(("spectral_stats_bwd", b, h, w, c, num_heads, shift, ln, str(dt)))
    return (dx, dw.reshape(3 * c, c, 1, 1), dwdw.reshape(3 * c, 1, 3, 3),
            *((sums[18 * c:19 * c], sums[19 * c:]) if ln else (None, None)))


def _stats_bwd_launch(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk):
    if x.dtype == torch.bfloat16:
        return _stats_bwd_tc_launch(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq,
                                    dnk)
    b, h, w, c = x.shape
    dt = x.dtype
    _build.check_plan("spectral_stats_bwd", "mp_spectral_stats_bwd_smem",
                      f"C={c}, heads={num_heads}", c, num_heads)
    x = x.contiguous()
    wq, wd = kernel_weight(wqkv, dt), kernel_weight(wdw, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dgram, dnq, dnk = f32(dgram), f32(dnq), f32(dnk)
    dev = x.device
    un = torch.empty((b, h, w, c), dtype=dt, device=dev)
    t = torch.empty((b, h, w, 2 * c), dtype=torch.float32, device=dev)
    dqk = torch.empty_like(t)
    err = _stats_entry("bwd")(x.data_ptr(), _build.ptr(lnw), _build.ptr(lnb), wq.data_ptr(),
                             wd.data_ptr(), dgram.data_ptr(), dnq.data_ptr(),
                             dnk.data_ptr(), un.data_ptr(), t.data_ptr(), dqk.data_ptr(), b, h,
                             w, c, num_heads, shift, eps, stream_ptr())
    _build.check("mp_spectral_stats_bwd", err)
    dtt, dwdw_qk = dwconv_bwd(dqk, t, wd, 0, dt)
    dx, dln, _ = ln_linear_bwd(dtt, wq, 0, x, ln_w, shift=-shift, eps=eps)
    dw = torch.zeros((3 * c, c), dtype=torch.float32, device=dev)
    dw[:2 * c] = wgrad(un.reshape(-1, c), dtt.reshape(-1, 2 * c)).t()
    dwdw = torch.zeros((3 * c, 9), dtype=torch.float32, device=dev)
    dwdw[:2 * c] = dwdw_qk.t()
    STATS_BWD.record(("spectral_stats_bwd", b, h, w, c, num_heads, shift, ln_w is not None, str(dt)))
    return (dx, dw.reshape(3 * c, c, 1, 1), dwdw.reshape(3 * c, 1, 3, 3),
            *(dln if dln is not None else (None, None)))


class _SpectralStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wdw, x2, ln_w, ln_b, cfg):
        num_heads, shift, eps = cfg
        ctx.kernel = ROUTE.use_kernel(x)
        fn = _stats_launch if ctx.kernel else spectral_stats_plain
        out = fn(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps)
        ctx.cfg = cfg
        ctx.has_x2 = x2 is not None
        ctx.save_for_backward(x, wqkv, wdw, ln_w, ln_b)
        return out

    @staticmethod
    def backward(ctx, dgram, dnq, dnk):
        x, wqkv, wdw, ln_w, ln_b = ctx.saved_tensors
        num_heads, shift, eps = ctx.cfg
        _no_eval_only_grad("spectral_stats", x2=True if ctx.has_x2 else None)
        b, c = x.shape[0], x.shape[-1]
        dh = c // num_heads
        z = x.new_zeros((b, c, dh), dtype=torch.float32)
        dgram = grad_or_zeros(dgram, z)
        dnq = grad_or_zeros(dnq, z[:, :num_heads])
        dnk = grad_or_zeros(dnk, z[:, :num_heads])
        if ctx.kernel:
            fn = _stats_bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = spectral_stats_bwd_plain
        dx, dw, dwdw, dlnw, dlnb = fn(x, wqkv, wdw, num_heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk)
        return dx, dw, dwdw, None, dlnw, dlnb, None


def spectral_stats(x, wqkv, wdw, num_heads: int, shift: int = 0, x2=None, ln_w=None,
                   ln_b=None, eps: float = 1e-5):
    """Same contract as :func:`spectral_stats_plain`, differentiable; launches
    the CUDA kernels (forward: a per-part pass, bf16 on the tensor-core tile,
    then an in-order sum of the parts; backward: bf16 the two tiles, float32
    ``mp_spectral_stats_bwd`` and grad.cu's stages) on a CUDA tensor."""
    return _SpectralStats.apply(x, wqkv, wdw, x2, ln_w, ln_b, (num_heads, shift, eps))


def spectral_fold(gram, nq, nk, temperature, wout) -> torch.Tensor:
    """comb (B, C, C) float32, row = v channel (h, e), col = output channel:
    comb[h*dh+e, o] = sum_d softmax_e(G[d, e] / (|q_d| |k_e|) * t_h) W[(h, d), o]."""
    b, c, dh = gram.shape
    nh = c // dh
    nqs = nq.sqrt().clamp_min(1e-12)
    nks = nk.sqrt().clamp_min(1e-12)
    attn = gram.reshape(b, nh, dh, dh) / (nqs[..., :, None] * nks[..., None, :])
    attn = torch.softmax(attn * temperature.float().reshape(1, nh, 1, 1), dim=-1)
    wr = wout.float().reshape(c, c).t().reshape(nh, dh, c)  # [(h, d)][o]
    return torch.einsum("bhde,hdo->bheo", attn, wr).reshape(b, c, c).contiguous()


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _gate_map(gate, shift):
    """Per-window gates of the rolled frame as a per-pixel map of the
    unrolled frame."""
    gmap = gate.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)
    return roll_hw(gmap, shift, shift) if shift else gmap


def spectral_apply_plain(x, comb, wqkv, wdw, shift: int = 0, x2=None, ln_w=None, ln_b=None,
                         residual: bool = False, gate=None, shortcut=None, mlp=None,
                         eps: float = 1e-5, dp_scale=None):
    """out = v @ comb [+ x * gate] [+ x] [+ shortcut], then optionally the
    PGSSTB tail ``out + fc2(a * gelu(g))``, ``[a|g] = fc1(LN2(out))``;
    ``mlp = (ln2_w, ln2_b, fc1_w (2h, C), fc1_b, fc2_w (C, h), fc2_b)``.
    ``gate`` (B, H/8, W/8, C) holds the per-window gates of the rolled frame.
    ``dp_scale`` (B,): per-sample drop-path scale of the branch
    ``v @ comb [+ x * gate]``, summed in float32 and rounded once.
    Output (B, H, W, C) in the unrolled frame."""
    dt = x.dtype
    raw, u = _input(x, x2, shift, ln_w, ln_b, eps)
    b, h, w, c = u.shape
    v = _qkv_part(u, wqkv, wdw, 2 * c, 3 * c, dt)[1]
    y = torch.einsum("bhwc,bco->bhwo", v, comb.to(dt).float())
    gu = None if gate is None else raw.float() * _gate_map(gate, shift).float()
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
                             eps, dy):
    """Explicit VJP of :func:`spectral_apply_plain` without x2 / mlp: returns
    (dx, d comb, d wqkv, d wdw, d ln_w, d ln_b, d gate, d shortcut, d dp);
    the q/k sections of the weight cotangents are zero."""
    dt = x.dtype
    raw, u = _input(x, None, shift, ln_w, ln_b, eps)
    b, h, w, c = u.shape
    wv = wqkv[2 * c:].reshape(c, c).to(dt).float()
    t, v = _qkv_part(u, wqkv, wdw, 2 * c, 3 * c, dt)
    dyf = dy.float()
    dys = dyf if dp_scale is None else (dyf * dp_scale.float().reshape(b, 1, 1, 1)).to(dt).float()
    cr = comb.to(dt).float()
    dcomb = torch.einsum("byxk,byxo->bko", v, dys)
    dv = torch.einsum("byxo,bko->byxk", dys, cr)
    extra = torch.zeros_like(dyf)
    dgate = ddp = gu = None
    if gate is not None:
        gmap = _gate_map(gate, shift).float()
        gu = raw.float() * gmap
        extra = extra + dys * gmap
        prod = dys * raw.float()
        prod = roll_hw(prod, -shift, -shift) if shift else prod
        dgate = prod.reshape(b, h // 8, 8, w // 8, 8, c).sum(dim=(2, 4)).to(gate.dtype)
    if residual:
        extra = extra + dyf
    if dp_scale is not None:
        br = torch.einsum("byxk,bko->byxo", v, cr)
        br = br if gu is None else br + gu
        ddp = (dyf * br).sum(dim=(1, 2, 3)).to(dp_scale.dtype)
    dtt, dwdw_v = dwconv3_bwd_plain(dv, t, wdw[2 * c:].to(dt))
    dtt = dtt.to(dt).float()
    dw = torch.zeros((3 * c, c), dtype=torch.float32, device=x.device)
    dw[2 * c:] = dtt.reshape(-1, c).t() @ u.float().reshape(-1, c)
    dwdw = torch.zeros((3 * c, 1, 3, 3), dtype=torch.float32, device=x.device)
    dwdw[2 * c:] = dwdw_v
    du = dtt @ wv
    dlnw = dlnb = None
    if ln_w is not None:
        du, dlnw, dlnb = ln_bwd_plain(du, *ln_stats(raw, eps), ln_w)
    du = du + extra
    dx = roll_hw(du, -shift, -shift) if shift else du
    return (dx.to(dt), dcomb, dw.reshape(3 * c, c, 1, 1), dwdw, dlnw, dlnb, dgate, dy, ddp)


def front_plan(c: int) -> dict:
    """The bf16 apply tile's tiling at width ``c`` (``FrontPlan`` in
    csrc/spectral_front.cuh): ``cp`` = c rounded up to 32, the 1x1 product's
    output passes of ``np`` columns, ``nk`` 64-deep weight tiles per pass."""
    cp = -(-c // 32) * 32
    nb = cp // 32
    passes = -(-7 * nb // (16 * FRONT_UNITS))
    return dict(cp=cp, passes=passes, np=32 * -(-nb // passes), nk=-(-cp // FRONT_K))


def pack_front(wqkv, wdw, comb, dt):
    """The operands the bf16 apply tile streams, in ``dt``: the v rows of
    the 1x1 weight as [C out][C8 in] (torch layout), their depthwise taps as
    [C][9], and ``comb`` as (B, C, C8); C8 is C rounded up to 8, the rows
    padded with zeros only where C is not a multiple of 8 (16-byte rows for
    the kernel's copies). Views of the weights where they are already in
    ``dt``; the kernel stages [np][64] tiles of the first and [64][cp] tiles
    of the last (:func:`front_plan`), zero past C."""
    c = wqkv.shape[1]
    wv, cb = wqkv[2 * c:].reshape(c, c).to(dt), comb.to(dt)
    if c % 8:
        wv, cb = F.pad(wv, (0, -c % 8)), F.pad(cb, (0, -c % 8))
    return wv.contiguous(), wdw[2 * c:].reshape(c, 9).to(dt).contiguous(), cb.contiguous()


def apply_bwd_tc_plan(c: int) -> dict:
    """The bf16 apply backward's plans at width ``c``: the first tile's
    (``ApplyBwdPlan`` in csrc/spectral_apply_bwd.cuh: :func:`front_plan`'s
    tiling; ``front`` = v [64][ld] | taps [9][cp] | halo [112][ld] | the
    weight ring of ``ws`` stages or a pass's 1x1 output, whichever is larger;
    after the front ``post`` = v | dys | ``cs`` comb stages of [64][ld], 3
    where they fit; ``bytes`` the larger) and the second tile's at K = C
    (``dx``: :func:`dwconv_dx_plan`)."""
    pl = front_plan(c)
    ld = pl["cp"] + 8
    v = 2 * 64 * ld
    ws = 2 if pl["passes"] > 1 else 3
    ring = max(ws * 2 * pl["np"] * FRONT_LDW, 2 * 100 * (pl["np"] + 8))
    front = v + 2 * 9 * pl["cp"] + 2 * FRONT_ROWS * ld + ring
    cs = 3 if 5 * v <= STATS_BUDGET else 2
    post = (2 + cs) * v
    return dict(pl, ld=ld, ws=ws, cs=cs, front=front, post=post, bytes=max(front, post),
                dx=dwconv_dx_plan(c, c))


@lru_cache(maxsize=None)
def _apply_entry(kind: str = "fwd"):
    import ctypes

    if kind == "bwd":
        return _build.entry("mp_spectral_apply_bwd", 17, [ctypes.c_int] * 8 + [ctypes.c_float])
    if kind == "bwd_tc":
        return _build.entry("mp_spectral_apply_bwd_tc", 16, [ctypes.c_int] * 7 + [ctypes.c_float])
    if kind == "dx_tc":
        return _build.entry("mp_spectral_apply_dx_tc", 10, [ctypes.c_int] * 6 + [ctypes.c_float])
    if kind == "gate":
        return _build.entry("mp_spectral_gate_grad", 3, [ctypes.c_int] * 5)
    return _build.entry("mp_spectral_apply", 17, [ctypes.c_int] * 10 + [ctypes.c_float])


def _apply_prepare(x, comb, wqkv, wdw, shift=0, x2=None, ln_w=None, ln_b=None, residual=False,
                   gate=None, shortcut=None, mlp=None, eps=1e-5, dp_scale=None):
    """Everything a launch needs: (the C entry's arguments, out, the tensors
    the arguments point into, to be held until the launch). Weights: float32
    [in][out] copies, bf16 :func:`pack_front`; the tail's
    :func:`pack_mlp_weights` in the compute type."""
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    c = c1 + c2
    if h % 8 or w % 8:
        raise ValueError(f"spectral apply needs H, W % 8 == 0, got {x.shape}")
    if (gate is not None or dp_scale is not None) and (x2 is not None or ln_w is not None):
        raise ValueError("the gate and drop-path epilogues take one raw input")
    dt, code = x.dtype, dtype_code(x)
    tail = int(mlp is not None)
    if code and c > FRONT_MAX_C:  # the front's and the tail tile's widest C
        raise ValueError(f"the bf16 spectral apply kernel takes C up to {FRONT_MAX_C}, got {c}")
    kc = _build.chunk("mp_spectral_apply_chunk", c, tail, code)
    _build.check_plan("spectral_apply", "mp_spectral_apply_smem",
                      f"C={c}, {'with' if tail else 'no'} MLP tail", c, tail, code, kc)
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    gate = None if gate is None else gate.to(dt).contiguous()
    shortcut = None if shortcut is None else shortcut.to(dt).contiguous()
    if code:
        wq, wd, cb = pack_front(wqkv, wdw, comb, dt)
    else:
        wq, wd, cb = kernel_weight(wqkv, dt), kernel_weight(wdw, dt), f32(comb)
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
            out.data_ptr(), code, b, h, w, c1, c2, int(residual), hid, shift, kc, eps,
            stream_ptr())
    return args, out, (x, x2, gate, shortcut, wq, wd, lnw, lnb, cb, dp, ln2w, ln2b, w1, b1, w2, b2)


def _apply_launch(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate, shortcut, mlp, eps,
                  dp_scale):
    args, out, _held = _apply_prepare(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate,
                                      shortcut, mlp, eps, dp_scale)
    _build.check("mp_spectral_apply", _apply_entry()(*args))
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    hid = 0 if mlp is None else mlp[4].shape[1]
    dt = x.dtype
    spec = ("spectral_apply", b, h, w, c1, c2, shift, ln_w is not None, bool(residual),
            gate is not None, shortcut is not None, hid, str(dt))
    APPLY.record(spec if dp_scale is None else spec[:-1] + ("dp", str(dt)))
    if hid and dt == torch.float32:
        TAIL_F32.record(("mlp_tail_f32", b, h, w, c1 + c2, hid))
    return out


def _apply_bwd_tc_launch(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps,
                         dy):
    """The bf16 backward: the two tiles, d gate, the two weight products and
    the in-order sums of the per-tile partial rows (the taps' [9][C], then d
    ln_w, d ln_b, then d dp): per image over its tiles, then over the images
    (d dp per image from the first)."""
    b, h, w, c = x.shape
    dt = x.dtype
    if c > FRONT_MAX_C:  # the widest C of both tiles' plans
        raise ValueError(f"the bf16 spectral apply backward takes C up to {FRONT_MAX_C}, got {c}")
    _build.check_plan("spectral_apply_bwd", "mp_spectral_apply_bwd_tc_smem", f"C={c}, tile 1", c, 1)
    _build.check_plan("spectral_apply_bwd", "mp_spectral_apply_bwd_tc_smem", f"C={c}, tile 2", c, 2)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    gate_t = None if gate is None else gate.to(dt).contiguous()
    wv, wd, cb = pack_front(wqkv, wdw, comb, dt)
    lnw, lnb, dp = f32(ln_w), f32(ln_b), f32(dp_scale)
    dev = x.device
    tiles = b * (h // 8) * (w // 8)
    like = dict(dtype=dt, device=dev)
    un, t, v, dtt, dx = (torch.empty((b, h, w, c), **like) for _ in range(5))
    dys = dy if dp is None else torch.empty_like(un)
    dv = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    extra = torch.empty_like(dv) if (gate is not None or residual) else None
    ln = lnw is not None
    o_dp = 9 * c + (2 * c if ln else 0)  # the part row: taps, [LN], [d dp]
    ldp = o_dp + int(dp is not None)
    part = torch.empty((b, tiles // b, ldp), dtype=torch.float32, device=dev)
    pdp = None if dp is None else part.data_ptr() + 4 * o_dp  # column o_dp of row 0
    p = _build.ptr
    err = _apply_entry("bwd_tc")(x.data_ptr(), p(lnw), p(lnb), wv.data_ptr(), wd.data_ptr(),
                                 cb.data_ptr(), p(gate_t), p(dp), dy.data_ptr(), un.data_ptr(),
                                 t.data_ptr(), v.data_ptr(), None if dp is None else dys.data_ptr(),
                                 dv.data_ptr(), p(extra), pdp, b, h, w, c, int(residual), shift,
                                 ldp, eps, stream_ptr())
    _build.check("mp_spectral_apply_bwd_tc", err)
    dgate = None
    if gate is not None:
        dgate = torch.empty((b, h // 8, w // 8, c), dtype=torch.float32, device=dev)
        err = _apply_entry("gate")(dys.data_ptr(), x.data_ptr(), dgate.data_ptr(), b, h, w, c,
                                   shift, stream_ptr())
        _build.check("mp_spectral_gate_grad", err)
    err = _apply_entry("dx_tc")(dv.data_ptr(), t.data_ptr(), wd.data_ptr(), wv.data_ptr(),
                                x.data_ptr(), p(lnw), p(extra), dtt.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), b, h, w, c, shift, ldp, eps, stream_ptr())
    _build.check("mp_spectral_apply_dx_tc", err)
    dw = torch.zeros((3 * c, c), dtype=torch.float32, device=dev)
    dw[2 * c:] = wgrad(un.reshape(-1, c), dtt.reshape(-1, c)).t()
    dcomb = wgrad(v.reshape(b, h * w, c), dys.reshape(b, h * w, c))
    per_image = sum_parts(part)
    sums = sum_parts(per_image.unsqueeze(0))[0]
    dwdw = torch.zeros((3 * c, 9), dtype=torch.float32, device=dev)
    dwdw[2 * c:] = sums[:9 * c].reshape(9, c).t()
    APPLY_BWD.record(("spectral_apply_bwd", b, h, w, c, shift, ln, bool(residual),
                      gate is not None, dp is not None, str(dt)))
    return (dx, dcomb, dw.reshape(3 * c, c, 1, 1), dwdw.reshape(3 * c, 1, 3, 3),
            *((sums[9 * c:10 * c], sums[10 * c:11 * c]) if ln else (None, None)),
            None if dgate is None else dgate.to(gate.dtype), dy,
            None if dp is None else per_image[:, o_dp].to(dp_scale.dtype))


def _apply_bwd_launch(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps, dy):
    if x.dtype == torch.bfloat16:
        return _apply_bwd_tc_launch(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate,
                                    dp_scale, eps, dy)
    b, h, w, c = x.shape
    dt = x.dtype
    kc = _build.chunk("mp_spectral_apply_bwd_chunk", c)
    _build.check_plan("spectral_apply_bwd", "mp_spectral_apply_bwd_smem", f"C={c}", c, kc)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    gate_t = None if gate is None else gate.to(dt).contiguous()
    wq, wd = kernel_weight(wqkv, dt), kernel_weight(wdw, dt)
    lnw, lnb, cb, dp = f32(ln_w), f32(ln_b), f32(comb), f32(dp_scale)
    dev = x.device
    tiles = (h // 8) * (w // 8)
    like = dict(dtype=dt, device=dev)
    un, v, dys = (torch.empty((b, h, w, c), **like) for _ in range(3))
    t = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    dv = torch.empty_like(t)
    extra = torch.empty_like(t) if (gate is not None or residual) else None
    pdp = torch.empty((b, tiles), dtype=torch.float32, device=dev) if dp is not None else None
    dgate = (torch.empty((b, h // 8, w // 8, c), dtype=torch.float32, device=dev)
             if gate is not None else None)
    p = _build.ptr
    err = _apply_entry("bwd")(x.data_ptr(), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(),
                              cb.data_ptr(), p(gate_t), p(dp), dy.data_ptr(), un.data_ptr(),
                              t.data_ptr(), v.data_ptr(), dys.data_ptr(), dv.data_ptr(), p(extra),
                              p(pdp), p(dgate), dtype_code(x), b, h, w, c, int(residual), shift,
                              kc, eps, stream_ptr())
    _build.check("mp_spectral_apply_bwd", err)
    dtt, dwdw_v = dwconv_bwd(dv, t, wd, 2 * c, dt)
    dx, dln, _ = ln_linear_bwd(dtt, wq, 2 * c, x, ln_w, extra_f=extra, shift=-shift, eps=eps)
    dw = torch.zeros((3 * c, c), dtype=torch.float32, device=dev)
    dw[2 * c:] = wgrad(un.reshape(-1, c), dtt.reshape(-1, c)).t()
    dwdw = torch.zeros((3 * c, 9), dtype=torch.float32, device=dev)
    dwdw[2 * c:] = dwdw_v.t()
    dcomb = wgrad(v.reshape(b, h * w, c), dys.reshape(b, h * w, c))
    ddp = None if pdp is None else sum_parts(pdp.unsqueeze(-1))[:, 0]
    APPLY_BWD.record(("spectral_apply_bwd", b, h, w, c, shift, ln_w is not None, bool(residual),
                      gate is not None, dp is not None, str(dt)))
    dlnw, dlnb = dln if dln is not None else (None, None)
    return (dx, dcomb, dw.reshape(3 * c, c, 1, 1), dwdw.reshape(3 * c, 1, 3, 3), dlnw, dlnb,
            None if dgate is None else dgate.to(gate.dtype), dy,
            None if ddp is None else ddp.to(dp_scale.dtype))


class _SpectralApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comb, wqkv, wdw, x2, ln_w, ln_b, gate, shortcut, dp_scale, ln2_w, ln2_b,
                w1, b1, w2, b2, cfg):
        shift, residual, eps = cfg
        mlp = None if w1 is None else (ln2_w, ln2_b, w1, b1, w2, b2)
        ctx.kernel = ROUTE.use_kernel(x)
        if ctx.kernel:
            out = _apply_launch(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate,
                                shortcut, mlp, eps, dp_scale)
        else:
            out = spectral_apply_plain(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual, gate,
                                       shortcut, mlp, eps, dp_scale)
        ctx.cfg = cfg
        ctx.eval_only = dict(x2=x2, mlp=w1)
        ctx.has_shortcut = shortcut is not None
        ctx.save_for_backward(x, comb, wqkv, wdw, ln_w, ln_b, gate, dp_scale)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, comb, wqkv, wdw, ln_w, ln_b, gate, dp_scale = ctx.saved_tensors
        shift, residual, eps = ctx.cfg
        _no_eval_only_grad("spectral_apply", **ctx.eval_only)
        dy = dy.contiguous()
        if ctx.kernel:
            fn = _apply_bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = spectral_apply_bwd_plain
        dx, dcomb, dw, dwdw, dlnw, dlnb, dgate, dshort, ddp = fn(
            x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps, dy)
        if not ctx.has_shortcut:
            dshort = None
        return (dx, dcomb, dw, dwdw, None, dlnw, dlnb, dgate, dshort, ddp,
                None, None, None, None, None, None, None)


def spectral_apply(x, comb, wqkv, wdw, shift: int = 0, x2=None, ln_w=None, ln_b=None,
                   residual: bool = False, gate=None, shortcut=None, mlp=None,
                   eps: float = 1e-5, dp_scale=None):
    """Same contract as :func:`spectral_apply_plain`, differentiable without
    ``x2`` / ``mlp``; launches the CUDA kernels on a CUDA tensor."""
    m = (None,) * 6 if mlp is None else tuple(mlp)
    return _SpectralApply.apply(x, comb, wqkv, wdw, x2, ln_w, ln_b, gate, shortcut, dp_scale,
                                *m, (shift, bool(residual), eps))
