"""The float32 spectral apply tile (K2 phase 1 and K7b in float32,
``spectral_apply_f32_kernel`` in csrc/spectral.cu: 3xTF32 on m16n8k8)
without a card: the plan mirror ``apply_f32_plan`` at every width, and the
tile emulated in numpy from its own tile map (per 8x8 tile of the unrolled
frame, the 10x10 halo with LN in float32 padded to 112 rows and to
32-channel chunks; per v column group the 1x1 against ``pack_front_f32``'
float32 v rows, k8 step by k8 step with the three TF32 products summed
toward zero and added in float32; the depthwise 3x3 by fmaf in tap order;
comb's product from the transposed pack in the same k8 steps; the
epilogues in float32) against ``spectral_apply_plain`` in float32 at the
presets' widths and the odd ones: the PGSSTB call unshifted and shifted
with its gate and shortcut, the PromptFusion entry (x2 + LN + residual) and
the training route's drop-path call (K7b); four planted faults the check
must catch; a row shard's halo rows at every edge-flag combination (the
rows above and below the map, LN'd like the map, zero at an image edge),
with rows swapped top for bottom as a planted fault; a member's head block
under the spectral mesh axis (v width CL = C / 2, comb (B, CL, C), 2
members at every preset width, the gate over n and the drop-path scale,
with and without halo rows), with comb's pack read as a (C, C) one and the
v rows read at the q rows' offset as planted faults; two cases against the
JAX package's ``fused_spectral_attention_nhwc`` phase 1 in interpret
mode. The kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py. Imports JAX only in the test
that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.kernels.spectral import (
    APPLY_F32_BUDGET, APPLY_F32_STATIC, F32_K, Halo, apply_f32_plan, pack_front_f32,
    spectral_apply_plain,
)
from tf32_emulation import mma
from torch_port_inputs import normal as _n, rng as _rng, tensor as _t
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# every width of the presets' float32 apply calls (PGSSTB 64, 128, 256 and
# 96, 192, 384; PromptFusion 128, 256, 192, 384; the training route's K7b at
# the same widths), C = 27, 36 and 54 (rows not 16-byte multiples: the halo
# by 4-byte copies; 27 odd) and C = 400 (three v column groups, two comb
# passes)
WIDTHS = [64, 128, 256, 96, 192, 384, 27, 36, 54, 400]
# (groups, group width, comb passes, pass width, 1x1 ring stages, comb ring
# stages, bytes with the static): without the tail, then with it
PLANS = {64: ((1, 64, 1, 64, 3, 3, 97600), 175040),
         128: ((1, 128, 1, 128, 3, 3, 143936), 191424),
         256: ((2, 128, 1, 256, 3, 3, 188224), 224192),
         96: ((1, 96, 1, 96, 3, 3, 120768), 191424),
         192: ((1, 192, 1, 192, 3, 3, 190272), 207808),
         384: ((2, 192, 1, 384, 2, 2, 225600), 225600),
         27: ((1, 32, 1, 32, 3, 3, 74432), 175040),
         36: ((1, 64, 1, 64, 3, 3, 97600), 175040),
         54: ((1, 64, 1, 64, 3, 3, 97600), 175040),
         400: ((3, 160, 2, 224, 2, 3, 221120), 221120)}
LIMIT = 232448  # the H100's shared memory per block (opt-in)
EPS = 1e-5
TOL = 2e-6  # of the output's max-abs: float32 both sides, sums in other orders
VARIANTS = ("pgsstb0", "pgsstb4", "fusion", "train")
HALO_EDGES = [(True, True), (True, False), (False, True), (False, False)]


def _fma(acc, a, b):
    """fmaf(a, b, acc) elementwise in float32 (the product exact)."""
    return (acc.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def _tiles(u, n=10, pad=1, rows=None):
    """(B, H, W, C) -> the n x n windows of the 8x8 tiles (the 10x10 halos
    with pad 1, the tiles themselves with n = 8, pad 0), (B, T, n * n, C),
    tiles in row-major order, zero outside the image; ``rows`` (pad 1): the
    (top, bottom) rows (B, 1, W, C) beyond the map's first and last rows."""
    b, h, w, c = u.shape
    up = np.zeros((b, h + 2 * pad, w + 2 * pad, c), np.float32)
    up[:, pad:pad + h, pad:pad + w] = u
    if rows is not None:
        up[:, :1, 1:-1], up[:, -1:, 1:-1] = rows
    return np.stack([up[:, 8 * ty:8 * ty + n, 8 * tx:8 * tx + n].reshape(b, n * n, c)
                     for ty in range(h // 8) for tx in range(w // 8)], axis=1)


def _emulate(x, comb, wqkv, wdw, shift=0, x2=None, ln_w=None, ln_b=None, residual=False,
             gate=None, shortcut=None, dp_scale=None, halo=None, three=True, chained=False,
             untransposed=False, unrolled_gate=False, swapped=False, comb_cc=False,
             v_at_q=False):
    """The tile on float32 inputs (spectral_apply_plain's arguments without
    the tail; v CL = wqkv.shape[0] / 3 wide): the output (B, H, W, C) in the
    unrolled frame. three=False: one TF32 product; chained: the products
    summed on the tensor cores across all of K; untransposed: comb's pack
    read as [v][out]; unrolled_gate: the gate read at the unrolled pixel's
    window; swapped: the halo rows staged top for bottom; comb_cc: a head
    block's comb pack read with a (C, C) pack's row stride; v_at_q: its v
    rows read at the q rows' offset (the planted faults)."""
    raw = np.roll(x.numpy(), (shift, shift), axis=(1, 2)) if shift else x.numpy()
    if x2 is not None:
        raw = np.concatenate([raw, x2.numpy()], axis=-1)

    def norm(t):
        if ln_w is None:
            return t
        mu = t.mean(-1, keepdims=True)
        rs = np.float32(1) / np.sqrt(((t - mu) ** 2).mean(-1, keepdims=True) + np.float32(EPS))
        return (t - mu) * rs * ln_w.numpy() + ln_b.numpy()

    u = norm(raw)
    b, h, w, c = u.shape
    rows = None
    if halo is not None:  # the rows beyond the shard: LN'd as the map, zero at an image edge
        rows = [np.zeros((b, 1, w, c), np.float32) if edge else norm(r.numpy())
                for r, edge in ((halo.top, halo.edge_top), (halo.bot, halo.edge_bot))]
        rows = rows[::-1] if swapped else rows
    cl = wqkv.shape[0] // 3
    pl = apply_f32_plan(c, cl=cl)
    cp, cpl, ck = pl["cp"], pl["cpl"], F32_K * pl["nk"]
    wv, taps, cbt = (t.numpy() for t in pack_front_f32(wqkv, wdw, comb))
    if v_at_q:  # (the pack may be a view of the weights: a copy)
        wv = wv.copy()
        wv[:, :c] = wqkv[:cl].reshape(cl, c).numpy()
    if comb_cc:  # the (B, C, CL8) pack read as rows of C8
        c8 = -(-c // 8) * 8
        flat = np.zeros((b, c * c8), np.float32)
        flat[:, :cbt[0].size] = cbt.reshape(b, -1)
        cbt = flat.reshape(b, c, c8)
    halo = np.zeros((b, (h // 8) * (w // 8), 112, ck), np.float32)
    halo[:, :, :100, :c] = _tiles(u, rows=rows)
    n_tiles = halo.shape[1]
    # v's 1x1 and depthwise 3x3, one column group at a time, into [64][cpl]
    v = np.zeros((b, n_tiles, 64, cpl), np.float32)
    for g0 in range(0, cpl, pl["gw"]):
        gw = min(pl["gw"], cpl - g0)
        wg = np.zeros((gw, ck), np.float32)
        tg = np.zeros((9, gw), np.float32)
        n = min(gw, cl - g0)
        wg[:n, :wv.shape[1]] = wv[g0:g0 + n]
        tg[:, :n] = taps[g0:g0 + n].T
        t = mma(np.zeros((b, n_tiles, 112, gw), np.float32), halo, wg.T, three, chained)
        t = t[:, :, :100].reshape(b, n_tiles, 10, 10, gw)
        s = np.zeros((b, n_tiles, 8, 8, gw), np.float32)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            s = _fma(s, t[:, :, dy:dy + 8, dx:dx + 8], tg[tap])
        v[..., g0:g0 + gw] = s.reshape(b, n_tiles, 64, gw)
    # comb's product: B[k][n] = comb^T's row n, column k (k < CL)
    bm = np.zeros((b, 1, cpl, cp), np.float32)
    bm[:, 0, :cl, :c] = cbt[:, :cl, :c] if untransposed else cbt[:, :c, :cl].transpose(0, 2, 1)
    acc = mma(np.zeros((b, n_tiles, 64, cp), np.float32), v, bm, three, chained)[..., :c]
    # the epilogue per tile pixel, in float32 as the kernel rounds
    o = acc
    ut = _tiles(raw, 8, 0)
    if gate is not None:
        gmap = np.repeat(np.repeat(gate.numpy(), 8, axis=1), 8, axis=2)
        gt = _tiles(gmap if unrolled_gate else np.roll(gmap, (shift, shift), axis=(1, 2)), 8, 0)
        ug = ut * gt
    if dp_scale is not None:
        o = (o + (ug if gate is not None else 0)) * dp_scale.numpy().reshape(b, 1, 1, 1)
    elif gate is not None:
        o = ug + o
    if residual:
        o = ut + o
    if shortcut is not None:
        o = _tiles(shortcut.numpy(), 8, 0) + o
    tx = w // 8
    return np.stack([np.stack([o[:, ty * tx + i].reshape(b, 8, 8, c) for i in range(tx)], axis=2)
                     for ty in range(h // 8)], axis=1).reshape(b, h, w, c)


def _inputs(variant, c, seed, h=16, w=16):
    """(args, kwargs) of one spectral_apply_plain call of the variant,
    float32, without the tail: the PGSSTB call at shift 0 or 4 with its gate
    and shortcut, the PromptFusion entry (x2 + LN + residual, C split in
    halves) or the training call (gate, drop-path, shortcut, shift 4)."""
    r = _rng(seed)
    wq = _t(_n(r, (3 * c, c, 1, 1), c ** -0.5))
    wd = _t(_n(r, (3 * c, 1, 3, 3), 1 / 3))
    comb = _t(_n(r, (1, c, c), c ** -0.5))
    x = _t(_n(r, (1, h, w, c)))
    if variant == "fusion":
        return [x[..., :c // 2].contiguous(), comb, wq, wd], dict(
            x2=x[..., c // 2:].contiguous(), ln_w=1 + _t(_n(r, (c,), 0.1)),
            ln_b=_t(_n(r, (c,), 0.1)), residual=True)
    kw = dict(shift=0 if variant == "pgsstb0" else 4, gate=_t(_n(r, (1, h // 8, w // 8, c), 0.5)),
              shortcut=_t(_n(r, (1, h, w, c))))
    if variant == "train":
        kw["dp_scale"] = torch.tensor([1.25])
    return [x, comb, wq, wd], kw


def _case(variant, c, edges=None, member=None, **faults):
    """(emulated, plain) of one call; ``edges``: with halo rows drawn from
    the seed, these edge flags (the call read in its own frame, shift 0);
    ``member``: that member's head block of 2 (its q|k|v rows of the
    weights, comb's first CL rows, the gate over 2)."""
    args, kw = _inputs(variant, c, 500 + c)
    if member is not None:
        from mp_hsir_tpu_torch.parallel.tp import qkv_rows

        cl = c // 2
        args = [args[0], args[1][:, :cl].contiguous(), qkv_rows(args[2], c, cl, member),
                qkv_rows(args[3], c, cl, member)]
        kw = dict(kw, shift=0, gate=kw["gate"] / 2, shortcut=None)
    if edges is not None:
        r = _rng(600 + c)
        w, cc = args[0].shape[2], args[1].shape[2]
        kw = dict(kw, shift=0, halo=Halo(_t(_n(r, (1, 1, w, cc))), _t(_n(r, (1, 1, w, cc))),
                                         *edges))
    got = _emulate(*args, **kw, **faults)
    ref = spectral_apply_plain(*args, **kw).numpy()
    return got, ref


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize("c", WIDTHS)
def test_apply_f32_plan(c):
    """The plan mirror at every width, without and with the tail: column
    groups, comb passes, ring stages and bytes (static included) as pinned,
    within the device's limit; the groups cover the v channels in units of
    32 columns, at most 192 a group (7 x 6 units of 16 x 32 over the 112 halo
    rows), the passes the output channels, at most 384 a pass (4 x 12 units
    over the 64 pixels); the v tile's row 4 words mod 32 (ldmatrix without
    bank conflicts); with the tail the plan holds the tail's scratch."""
    from mp_hsir_tpu_torch.ops.kernels.mlp import tail_f32_plan

    plain, tailed = apply_f32_plan(c), apply_f32_plan(c, True)
    want, want_tail = PLANS[c]
    assert (plain["groups"], plain["gw"], plain["passes"], plain["np"], plain["ws"], plain["cs"],
            plain["bytes"]) == want
    assert tailed["bytes"] == want_tail == max(plain["front"], tail_f32_plan(c)["bytes"]) + 960
    for pl in (plain, tailed):
        assert pl["bytes"] <= LIMIT and pl["dyn"] <= APPLY_F32_BUDGET
        assert pl["bytes"] == pl["dyn"] + APPLY_F32_STATIC
    cp = plain["cp"]
    assert cp % 32 == 0 and c <= cp < c + 32 and plain["nk"] * F32_K == cp
    assert plain["gw"] % 32 == 0 and plain["gw"] <= 192
    assert (plain["groups"] - 1) * plain["gw"] < cp <= plain["groups"] * plain["gw"]
    assert plain["np"] % 32 == 0 and plain["np"] <= 384
    assert (plain["passes"] - 1) * plain["np"] < cp <= plain["passes"] * plain["np"]
    assert plain["ldv"] % 32 == 4


@pytest.mark.parametrize("c", [64, 128, 36, 27])
def test_pack_front_f32_layout(c):
    """pack_front_f32: the v rows of wqkv [C][C8] and their taps [C][9] as
    pack_front packs them, and comb transposed [B][C out][C8 in] (rows padded
    with zeros to C8 only where C is not a multiple of 8), all float32 and
    contiguous."""
    r = _rng(9)
    wqkv, wdw = _t(_n(r, (3 * c, c, 1, 1))), _t(_n(r, (3 * c, 1, 3, 3)))
    comb = _t(_n(r, (2, c, c)))
    wv, taps, cbt = pack_front_f32(wqkv, wdw, comb)
    c8 = -(-c // 8) * 8
    assert wv.shape == (c, c8) and taps.shape == (c, 9) and cbt.shape == (2, c, c8)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (wv, taps, cbt))
    assert torch.equal(wv[:, :c], wqkv[2 * c:].reshape(c, c))
    assert torch.equal(taps, wdw[2 * c:].reshape(c, 9))
    assert torch.equal(cbt[:, :, :c], comb.transpose(1, 2))
    assert not wv[:, c:].any() and not cbt[:, :, c:].any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("c", WIDTHS)
def test_apply_f32_emulation_matches_plain(variant, c):
    """The emulated tile against spectral_apply_plain in float32 on one
    16x16 map (4 tiles): within 2e-6 of the output's max-abs."""
    got, ref = _case(variant, c)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("fault", [dict(three=False), dict(chained=True),
                                   dict(untransposed=True), dict(unrolled_gate=True)],
                         ids=["one-tf32-product", "chained-k8-sums", "comb-not-transposed",
                              "gate-unrolled"])
def test_apply_f32_emulation_sees_the_faults(fault):
    """The check is not blind: one TF32 product instead of three (10-bit
    operands), the k8 steps' sums chained on the tensor cores (each add
    truncated) instead of flushed into float32, comb's pack read without its
    transpose, and a shifted block's gate read at the unrolled pixel's window
    each break the bound at C = 400, shift 4."""
    got, ref = _case("pgsstb4", 400, **fault)
    assert _rel(got, ref) > TOL, _rel(got, ref)


@pytest.mark.parametrize("edges", HALO_EDGES, ids=lambda e: f"edge{int(e[0])}{int(e[1])}")
@pytest.mark.parametrize("variant,c", [("pgsstb0", 64), ("fusion", 64), ("pgsstb0", 27)])
def test_apply_f32_emulation_with_halo_rows_matches_plain(variant, c, edges):
    """A row shard (K7b): the emulated tile with the rows above and below the
    map as its halo's first and last rows (LN'd like the map; zero where the
    flag says image edge) against spectral_apply_plain with the same
    Halo, within 2e-6 of the output's max-abs."""
    got, ref = _case(variant, c, edges)
    assert _rel(got, ref) <= TOL, _rel(got, ref)


def test_apply_f32_emulation_sees_swapped_halo_rows():
    """The halo check is not blind: the rows staged top for bottom break the
    bound (both rows real)."""
    got, ref = _case("fusion", 64, (False, False), swapped=True)
    assert _rel(got, ref) > TOL, _rel(got, ref)


# the presets' apply widths whose heads a spectral axis of 2 divides: each
# member's v block is C / 2 wide
TP_WIDTHS = [64, 128, 256, 96, 192, 384]


@pytest.mark.parametrize("member", [0, 1])
@pytest.mark.parametrize("c", TP_WIDTHS)
def test_apply_f32_head_block_plan_and_emulation(c, member):
    """A member's head block (v CL = C / 2 wide, comb (B, CL, C), the gate
    over 2 and the drop-path scale, shift 0: the training call of the TP
    route): its plan no larger than the whole attention's (no tail), the
    1x1 still C deep; the emulated tile against spectral_apply_plain within
    2e-6 of the output's max-abs, with interior halo rows for member 1."""
    pl, whole = apply_f32_plan(c, cl=c // 2), apply_f32_plan(c)
    assert pl["nk"] == whole["nk"] and pl["nkv"] * F32_K == pl["cpl"] >= c // 2
    assert pl["bytes"] <= whole["bytes"] and pl["np"] == whole["np"]
    got, ref = _case("train", c, (False, False) if member else None, member=member)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("fault", [dict(comb_cc=True), dict(v_at_q=True)],
                         ids=["comb-as-CxC", "v-at-q-offset"])
def test_apply_f32_head_block_emulation_sees_the_faults(fault):
    """The head-block check is not blind: comb's (C, CL) pack read with a
    (C, C) pack's row stride, and the v rows read at the q rows' offset,
    each break the bound (C = 128, member 1)."""
    got, ref = _case("train", 128, (False, False), member=1, **fault)
    assert _rel(got, ref) > TOL, _rel(got, ref)


@pytest.mark.parametrize("fusion", [False, True])
def test_apply_f32_emulation_matches_pallas_interpret(fusion):
    """The emulated tile against phase 1 of the JAX package's
    fused_spectral_attention_nhwc in interpret mode (float32, the stats
    precomputed by spectral_stats_plain and folded by spectral_fold): a
    shifted PGSSTB call with its gate and shortcut; and the PromptFusion
    entry (x2 + LN + residual), which the JAX function runs in both phases
    (it takes no precomputed stats there); at the tolerance
    tests/test_torch_kernels.py holds the plain version to."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops import pallas_attention as PA
    from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_fold, spectral_stats_plain
    from torch_port_inputs import oihw, spectral_weights

    c, heads, h, w = 32, 2, 24, 16
    r = _rng(31)
    sw = spectral_weights(r, c, heads)
    wqkv, wdw, wout = oihw(sw["wqkv"]), oihw(sw["wdw"]), oihw(sw["wout"])
    if fusion:
        x, x2 = _n(r, (1, h, w, c // 2)), _n(r, (1, h, w, c // 2))
        ln_w, ln_b = 1 + _n(r, (c,), 0.1), _n(r, (c,), 0.1)
        kw = dict(x2=_t(x2), ln_w=_t(ln_w), ln_b=_t(ln_b), residual=True)
        jkw = dict(x2=jnp.asarray(x2), ln_w=jnp.asarray(ln_w), ln_b=jnp.asarray(ln_b),
                   residual=True)
        pre = None
        skw = dict(x2=_t(x2), ln_w=_t(ln_w), ln_b=_t(ln_b))
    else:
        x, short = _n(r, (1, h, w, c)), _n(r, (1, h, w, c))
        gate = _n(r, (1, h // 8, w // 8, c), 0.5)
        kw = dict(shift=4, gate=_t(gate), shortcut=_t(short))
        jkw = dict(gate=jnp.asarray(gate), shortcut=jnp.asarray(short), shifted=True)
        skw = dict(shift=4)
    stats = spectral_stats_plain(_t(x), wqkv, wdw, heads, **skw)
    if not fusion:
        pre = tuple(jnp.asarray(s.numpy()) for s in stats)
    want = PA.fused_spectral_attention_nhwc(
        jnp.asarray(x), jnp.asarray(sw["wqkv"]), jnp.asarray(sw["wdw"]), jnp.asarray(sw["temp"]),
        jnp.asarray(sw["wout"]), heads, precomputed=pre, interpret=True, **jkw)
    comb = spectral_fold(*stats, _t(sw["temp"]), wout)
    got = _emulate(_t(x), comb, wqkv, wdw, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
