"""Each kernel module of the PyTorch port against the JAX Pallas function it
replaces, run in interpret mode on the CPU (as tests/test_pallas_attention.py
runs them), on the same numpy-seeded inputs. The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances (float32 on both sides): the Pallas kernels fold scales into
weights, use exp2 without the max-subtract, a -1e9 mask instead of -100 and a
polynomial GELU (1.5e-6 from erf), and sum in other orders, so results agree
to a few float32 ulps of the activations' scale: atol 1e-4, rtol 1e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mp_hsir_tpu.ops import pallas_attention as PA
from mp_hsir_tpu_torch.ops.kernels import _route
from mp_hsir_tpu_torch.ops.kernels.conv3 import CHUNK_K, TILE_N, conv3, conv3_plain, pack_weight
from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels.gdfn import gdfn_plain
from mp_hsir_tpu_torch.ops.kernels.mlp import TAIL_K, mlp_plain, pack_mlp_weights
from mp_hsir_tpu_torch.ops.kernels._grad import dwconv3_f32
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    FRONT_K, FRONT_ROWS, STATS_BUDGET, front_plan, pack_front, pack_stats, qk_row,
    spectral_apply_plain, spectral_fold, spectral_stats_plain, stats_plan,
)
from mp_hsir_tpu_torch.ops.kernels.window_attention import (
    HEAD_WIDTHS, K_CHUNK, head_width, pack_proj_weight, pack_qkv_weight, window_attention_plain,
)
from mp_hsir_tpu_torch.ops.window import shifted_region_map
from torch_port_inputs import (
    normal as _n, oihw as _oihw, rng as _rng, spectral_weights as _spectral_weights,
    tensor as _t, uniform as _u, window_inputs as _window_inputs,
)

ATOL = RTOL = 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_matches_pallas(shifted, merged):
    """fused_ln_window_attention_nhwc (K1; with sp_qk the merged K3, whose
    Gram/norm outputs the port's stats launch must reproduce). H = 24 gives
    the merged kernel three slabs, so its interior halo branches run."""
    c, heads, h, w = 16, 2, 24, 32
    d = _window_inputs(0, c, heads, h, w)
    shift = 4 if shifted else 0
    region = jnp.asarray(shifted_region_map(h, w, 8, 4)) if shifted else None
    sp_qk = (jnp.asarray(d["wqkv_sp"]), jnp.asarray(d["wdw_sp"]), heads) if merged else None
    outs = PA.fused_ln_window_attention_nhwc(
        jnp.asarray(d["x"]), jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"]),
        jnp.asarray(d["wqkv"]), jnp.asarray(d["bqkv"]), jnp.asarray(d["rel_bias"]),
        jnp.asarray(d["wp"]), jnp.asarray(d["bp"]), region, heads,
        shift_in=shifted, sp_qk=sp_qk, interpret=True)
    out, pooled = window_attention_plain(
        _t(d["x"]), _t(d["ln_w"]), _t(d["ln_b"]), _t(d["wqkv"]).t(), _t(d["bqkv"]),
        _t(d["rel_bias"]), _t(d["wp"]).t(), _t(d["bp"]), heads, shift=shift)
    _close(out, outs[0])
    _close(pooled, outs[1])
    if merged:
        wqkv = _t(d["wqkv_sp"]).t().reshape(3 * c, c, 1, 1)
        wdw = _t(d["wdw_sp"]).t().reshape(3 * c, 1, 3, 3)
        gram, nq, nk = spectral_stats_plain(out, wqkv, wdw, heads, shift=shift)
        for got, want in zip((gram, nq, nk), outs[2:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("shifted", [False, True])
def test_spectral_pgsstb_epilogue_matches_pallas(shifted):
    """fused_spectral_attention_nhwc with precomputed stats + gate + shortcut
    (+ shifted roll-back) + the PGSSTB tail MLP (K2 phase 1 as PGSSTB runs it)."""
    c, heads, h, w, hid = 16, 2, 24, 32, 42
    rng = _rng(1)
    sw = _spectral_weights(rng, c, heads)
    x, short = _n(rng, (1, h, w, c)), _n(rng, (1, h, w, c))
    gate = _n(rng, (1, h // 8, w // 8, c), 0.5)
    mlp = (1 + _n(rng, (c,), 0.1), _n(rng, (c,), 0.1), _u(rng, (c, 2 * hid), c),
           _u(rng, (2 * hid,), c), _u(rng, (hid, c), hid), _u(rng, (c,), hid))
    shift = 4 if shifted else 0
    wqkv, wdw, wout = _oihw(sw["wqkv"]), _oihw(sw["wdw"]), _oihw(sw["wout"])
    gram, nq, nk = spectral_stats_plain(_t(x), wqkv, wdw, heads, shift=shift)
    want = PA.fused_spectral_attention_nhwc(
        jnp.asarray(x), jnp.asarray(sw["wqkv"]), jnp.asarray(sw["wdw"]),
        jnp.asarray(sw["temp"]), jnp.asarray(sw["wout"]), heads, gate=jnp.asarray(gate),
        shortcut=jnp.asarray(short), shifted=shifted,
        mlp=tuple(jnp.asarray(m) for m in mlp),
        precomputed=(jnp.asarray(gram.numpy()), jnp.asarray(nq.numpy()),
                     jnp.asarray(nk.numpy())), interpret=True)
    comb = spectral_fold(gram, nq, nk, _t(sw["temp"]), wout)
    got = spectral_apply_plain(
        _t(x), comb, wqkv, wdw, shift=shift, gate=_t(gate), shortcut=_t(short),
        mlp=(_t(mlp[0]), _t(mlp[1]), _t(mlp[2]).t(), _t(mlp[3]), _t(mlp[4]).t(), _t(mlp[5])))
    _close(got, want)


def test_spectral_prompt_fusion_entry_matches_pallas():
    """fused_spectral_attention_nhwc with x2 + LN + residual (PromptFusion's
    entry: two-phase, so stats + fold + apply together)."""
    c1, heads, h, w = 16, 4, 24, 16
    c = 2 * c1
    rng = _rng(2)
    sw = _spectral_weights(rng, c, heads)
    x, x2 = _n(rng, (1, h, w, c1)), _n(rng, (1, h, w, c1))
    ln_w, ln_b = 1 + _n(rng, (c,), 0.1), _n(rng, (c,), 0.1)
    want = PA.fused_spectral_attention_nhwc(
        jnp.asarray(x), jnp.asarray(sw["wqkv"]), jnp.asarray(sw["wdw"]), jnp.asarray(sw["temp"]),
        jnp.asarray(sw["wout"]), heads, ln_w=jnp.asarray(ln_w), ln_b=jnp.asarray(ln_b),
        residual=True, x2=jnp.asarray(x2), interpret=True)
    wqkv, wdw = _oihw(sw["wqkv"]), _oihw(sw["wdw"])
    stats = spectral_stats_plain(_t(x), wqkv, wdw, heads, x2=_t(x2), ln_w=_t(ln_w), ln_b=_t(ln_b))
    comb = spectral_fold(*stats, _t(sw["temp"]), _oihw(sw["wout"]))
    got = spectral_apply_plain(_t(x), comb, wqkv, wdw, x2=_t(x2), ln_w=_t(ln_w), ln_b=_t(ln_b),
                               residual=True)
    _close(got, want)


@pytest.mark.parametrize("mode,cin,cout", [("plain", 5, 7), ("res", 6, 4), ("down", 6, 3),
                                           ("up", 6, 8)])
def test_conv3_matches_pallas(mode, cin, cout):
    """fused_conv3x3_{,res_,down_,up_}nhwc (K4): channel order of the
    (un)shuffle writebacks included."""
    rng = _rng(3)
    x = _n(rng, (2, 24, 16, cin))
    w = _n(rng, (3, 3, cin, cout))
    res = _n(rng, (2, 24, 16, cout))
    fn = {"plain": PA.fused_conv3x3_nhwc, "down": PA.fused_conv3x3_down_nhwc,
          "up": PA.fused_conv3x3_up_nhwc}
    if mode == "res":
        want = PA.fused_conv3x3_res_nhwc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(res),
                                         interpret=True)
    else:
        want = fn[mode](jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = conv3_plain(_t(x), _oihw(w), mode, _t(res) if mode == "res" else None)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("cin,cout", [(5, 7), (31, 64), (100, 48), (64, 512), (768, 100)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv3_pack_weight_layout(cin, cout, dt):
    """The weight layout the conv3 kernel stages: [Cout/64][Cin/16][9][16][64],
    the unpadded block equal to the OIHW weight (tap 3 ky + kx), the padding
    zeros."""
    w = _t(_n(_rng(9), (cout, cin, 3, 3)))
    wk = pack_weight(w, dt)
    nt, nc = -(-cout // TILE_N), -(-cin // CHUNK_K)
    assert wk.shape == (nt, nc, 9, CHUNK_K, TILE_N) and wk.dtype == dt and wk.is_contiguous()
    # [nt][nc][tap][k][n] -> (Cout padded, Cin padded, 3, 3)
    full = wk.permute(0, 4, 1, 3, 2).reshape(nt * TILE_N, nc * CHUNK_K, 3, 3)
    assert torch.equal(full[:cout, :cin], w.to(dt))
    pad = torch.ones_like(full, dtype=torch.bool)
    pad[:cout, :cin] = False
    assert not full[pad].any()
    n, k, ky, kx = cout - 1, cin - 1, 2, 1
    assert wk[n // TILE_N, k // CHUNK_K, 3 * ky + kx, k % CHUNK_K, n % TILE_N] == w[n, k, ky, kx].to(dt)


# (C, heads): dh 8 padded to 16 and C to one 64-deep chunk; dh 48 with C 96
# padded to 128; no padding at 64 / 2 and 384 / 8 (the remote-sensing latent)
@pytest.mark.parametrize("c,heads", [(16, 2), (96, 2), (64, 2), (384, 8)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_window_pack_weight_layout(c, heads, dt):
    """The weight layouts the bf16 window kernels stream: qkv slab h holds
    exactly head h's q, k and v rows of the torch-Linear weight, the
    projection chunk j output rows j*dh .. with head h's input columns at
    h*DHP; every padding is zero; O Wp through the packs is the projection."""
    r = _rng(12)
    wqkv, wp = _t(_n(r, (3 * c, c))), _t(_n(r, (c, c)))
    dh = c // heads
    dhp, kx = head_width(dh), -(-c // K_CHUNK) * K_CHUNK
    ko = -(-heads * dhp // K_CHUNK) * K_CHUNK
    assert dhp in HEAD_WIDTHS and dh <= dhp < dh + 16
    wk = pack_qkv_weight(wqkv, heads, dt)
    assert wk.shape == (heads, 3, dhp, kx) and wk.dtype == dt and wk.is_contiguous()
    pad = torch.ones_like(wk, dtype=torch.bool)
    for h in range(heads):
        for sec in range(3):
            rows = wqkv[sec * c + h * dh:sec * c + (h + 1) * dh]
            assert torch.equal(wk[h, sec, :dh, :c], rows.to(dt))
            pad[h, sec, :dh, :c] = False
    assert not wk[pad].any()
    pk = pack_proj_weight(wp, heads, dt)
    assert pk.shape == (heads, dhp, ko) and pk.dtype == dt and pk.is_contiguous()
    pad = torch.ones_like(pk, dtype=torch.bool)
    for j in range(heads):
        for h in range(heads):
            block = wp[j * dh:(j + 1) * dh, h * dh:(h + 1) * dh]
            assert torch.equal(pk[j, :dh, h * dhp:h * dhp + dh], block.to(dt))
            pad[j, :dh, h * dhp:h * dhp + dh] = False
    assert not pk[pad].any()
    # the heads' output o (64, C) packed as the kernel keeps it, times each chunk
    o = _t(_n(r, (64, c)))
    op = torch.zeros(64, ko)
    op[:, :heads * dhp].unflatten(-1, (heads, dhp))[..., :dh] = o.reshape(64, heads, dh)
    y = torch.cat([(op @ pk[j].float().t())[:, :dh] for j in range(heads)], dim=1)
    torch.testing.assert_close(y, o @ wp.to(dt).float().t(), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="head widths up to 128"):
        head_width(129)


# (C, hid): the tiny width, then every PGSSTB width of the two presets
# (hid = int(2.66 C): never a multiple of 16, so the last chunk is ragged)
@pytest.mark.parametrize("c,hid", [(16, 42), (64, 170), (128, 340), (96, 255), (192, 510),
                                   (384, 1021)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_mlp_pack_weight_layout(c, hid, dt):
    """The weight layouts the bf16 tail tile streams: slab j of the fc1 pack
    holds exactly chunk j's a-rows and g-rows of the torch-Linear weight at
    the interleaved rows (32 q + i: a-unit 64 j + 16 q + i, 32 q + 16 + i:
    its g-row), fc2's pack is its weight; every padding is zero; the MLP
    computed chunk by chunk through the packs (float32 sums) is mlp_plain's."""
    r = _rng(13)
    w1, w2 = _t(_u(r, (2 * hid, c), c)), _t(_u(r, (c, hid), hid))
    b1, b2 = _t(_u(r, (2 * hid,), c)), _t(_u(r, (c,), hid))
    ck, hp = -(-c // TAIL_K) * TAIL_K, -(-hid // TAIL_K) * TAIL_K
    w1p, w2p = pack_mlp_weights(w1, w2, dt)
    assert w1p.shape == (hp // TAIL_K, 128, ck) and w1p.dtype == dt and w1p.is_contiguous()
    assert w2p.shape == (ck, hp) and w2p.dtype == dt and w2p.is_contiguous()
    pad = torch.ones_like(w1p, dtype=torch.bool)
    for j in range(hp // TAIL_K):
        for q in range(4):
            for i in range(16):
                u = j * TAIL_K + 16 * q + i
                if u < hid:
                    assert torch.equal(w1p[j, 32 * q + i, :c], w1[u].to(dt))
                    assert torch.equal(w1p[j, 32 * q + 16 + i, :c], w1[hid + u].to(dt))
                    pad[j, [32 * q + i, 32 * q + 16 + i], :c] = False
    assert not w1p[pad].any()
    assert torch.equal(w2p[:c, :hid], w2.to(dt))
    assert not w2p[c:].any() and not w2p[:, hid:].any()
    # the tile's two products, chunk by chunk, in float32 on the rounded weights
    x = _t(_n(r, (2, 8, 8, c)))
    lw, lb = 1 + _t(_n(r, (c,), 0.1)), _t(_n(r, (c,), 0.1))
    xn = torch.zeros(128, ck)
    xn[:, :c] = layer_norm(x, lw, lb, 1e-5).reshape(128, c)
    ba, bg = torch.zeros(hp), torch.zeros(hp)
    ba[:hid], bg[:hid] = b1[:hid], b1[hid:]
    y = torch.zeros(128, ck)
    for j in range(hp // TAIL_K):
        h = (xn @ w1p[j].float().t()).reshape(128, 4, 2, 16)
        units = slice(j * TAIL_K, (j + 1) * TAIL_K)
        a = h[:, :, 0] + ba[units].reshape(4, 16)
        g = h[:, :, 1] + bg[units].reshape(4, 16)
        y += (a * gelu_exact(g)).reshape(128, TAIL_K) @ w2p[:, units].float().t()
    want = mlp_plain(x, lw, lb, w1.to(dt).float(), b1, w2.to(dt).float(), b2)
    torch.testing.assert_close(y[:, :c].reshape(x.shape) + b2, want, atol=1e-5, rtol=1e-5)


def _stage(flat, lds, r0, c0, rows, cols, rmax, cmax):
    """The bf16 apply tile's stage_tile in numpy: element (r, c) of the staged
    tile is flat[(r0 + r) * lds + c0 + c] where r < rmax and c < cmax, else 0."""
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    ok = (r < rmax) & (c < cmax)
    return np.where(ok, flat[np.where(ok, (r0 + r) * lds + c0 + c, 0)], 0)


# every width of the presets' spectral apply calls (PGSSTB 64-384, the
# PromptFusion 128 and 256 and the remote-sensing fusion's 384), and C = 36:
# rows padded to 40 (c8) and the tiles to 64 (cp), a partial last 64-deep tile
@pytest.mark.parametrize("c", [64, 128, 256, 96, 192, 384, 36])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_spectral_front_pack_layout(c, dt):
    """The operands the bf16 apply tile streams (pack_front), read with the
    kernel's own indexing: the [np][64] weight tiles of every 1x1 pass give
    back the v rows of wqkv, the staged [9][cp] taps the v rows' depthwise
    taps, the [64][cp] comb tiles comb itself, all exactly and zero past C
    (the rows padded to c8, a multiple of 8, only where C is not one);
    the tile's three products through those tiles (float32 sums) are the
    plain version's 1x1, depthwise 3x3 and comb product."""
    r = _rng(14)
    wqkv, wdw = _t(_u(r, (3 * c, c, 1, 1), c)), _t(_u(r, (3 * c, 1, 3, 3), 9))
    comb = _t(_n(r, (2, c, c), c ** -0.5))
    wv, taps, cb = pack_front(wqkv, wdw, comb, dt)
    c8 = -(-c // 8) * 8
    assert wv.shape == (c, c8) and taps.shape == (c, 9) and cb.shape == (2, c, c8)
    assert all(t.dtype == dt and t.is_contiguous() for t in (wv, taps, cb))
    pl = front_plan(c)
    cp, npass = pl["cp"], pl["np"]
    assert cp % 32 == 0 and c <= cp < c + 32 and pl["nk"] * FRONT_K >= cp
    assert pl["passes"] * npass >= cp and 7 * npass // 32 <= 48  # 3 units of 16 x 32 per warp
    flat_w = wv.float().numpy().ravel()
    got = np.zeros((cp, pl["nk"] * FRONT_K), np.float32)
    for n0 in range(0, cp, npass):
        n = min(npass, cp - n0)
        for t in range(pl["nk"]):
            got[n0:n0 + n, FRONT_K * t:FRONT_K * (t + 1)] = _stage(
                flat_w, c8, n0, FRONT_K * t, n, FRONT_K, c - n0, c8 - FRONT_K * t)
    want_w = wqkv[2 * c:].reshape(c, c).to(dt).float().numpy()
    np.testing.assert_array_equal(got[:c, :c], want_w)
    assert not got[c:].any() and not got[:, c:].any()
    flat_t = taps.float().numpy().ravel()
    tp = np.array([[flat_t[k * 9 + tap] if k < c else 0 for k in range(cp)] for tap in range(9)])
    np.testing.assert_array_equal(tp[:, :c], wdw[2 * c:].reshape(c, 9).t().to(dt).float().numpy())
    assert not tp[:, c:].any()
    flat_c = cb.float().numpy().ravel()
    for b in range(2):
        ct = np.concatenate([_stage(flat_c, c8, b * c + FRONT_K * t, 0, FRONT_K, cp,
                                    c - FRONT_K * t, c8) for t in range(pl["nk"])])
        np.testing.assert_array_equal(ct[:c, :c], comb[b].to(dt).float().numpy())
        assert not ct[c:].any() and not ct[:, c:].any()
    # the three products on one image's 10x10 halo (112 rows: 12 zero rows of
    # padding) through the staged tiles, against the plain version's
    x = _t(_n(r, (1, 10, 10, c))).to(dt).float()
    halo = np.zeros((FRONT_ROWS, got.shape[1]), np.float32)
    halo[:100, :c] = x.reshape(100, c).numpy()
    t1 = halo @ got.T[:, :cp]
    np.testing.assert_allclose(t1[:100, :c], (x @ torch.from_numpy(want_w).t()).reshape(100, c),
                               atol=1e-5, rtol=1e-5)
    assert not t1[:, c:].any()
    t1 = torch.from_numpy(t1[:100]).to(dt).float()
    v = dwconv3_f32(t1[:, :c].reshape(1, 10, 10, c), wdw[2 * c:].to(dt))[:, 1:9, 1:9]
    vt = np.zeros((64, cp), np.float32)
    for p in range(64):
        pr, pc = divmod(p, 8)
        for tap in range(9):
            vt[p] += t1.numpy()[(pr + tap // 3) * 10 + pc + tap % 3] * tp[tap]
    np.testing.assert_allclose(vt[:, :c], v.reshape(64, c).numpy(), atol=1e-5, rtol=1e-5)
    vt = torch.from_numpy(vt).to(dt).float().numpy()
    np.testing.assert_allclose((vt @ ct[:cp])[:, :c], vt[:, :c] @ comb[1].to(dt).float().numpy(),
                               atol=1e-4, rtol=1e-4)


def _dyadic(r, shape, scale, p):
    """Values k * scale, k in {-2..2}, nonzero with probability p: every sum
    the stats tile and its plain version take at these sizes is exact in
    float32 and every rounding point exact in bf16, so the two agree whatever
    their summation order."""
    k = r.integers(-2, 3, shape) * (r.random(shape) < p)
    return (k * scale).astype(np.float32)


# every (C, heads) of the presets' stats calls (flagship 64/2, 128/4, 128/2,
# 256/8; remote sensing 96/2, 192/2, 384/8) and C = 36 (dh 18 padded to 32,
# rows to 40) and 27 (dh 9 padded to 16, an odd C)
@pytest.mark.parametrize("c,heads", [(64, 2), (128, 4), (128, 2), (256, 8), (96, 2), (192, 2),
                                     (384, 8), (36, 2), (27, 3)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_spectral_stats_pack_layout(c, heads, dt):
    """The operands the bf16 stats tile streams (pack_stats), read with the
    kernel's own indexing (stats_plan, qk_row): the [np][64] weight tiles of
    every pass give back the q|k rows of wqkv in the head-grouped order and
    the staged [9][nqk] taps their depthwise taps, exactly, with zeros for the
    padding columns and past C. Then the tile emulated in numpy on a shifted
    16x24 image (6 tiles) in 4 parts: the 112-row halo through the roll-back,
    each group's 1x1 passes rounded to dt, the depthwise 3x3 rounded to dt,
    each head's Gram and the norms per part, the parts summed in order;
    against spectral_stats_plain at 1e-5 relative."""
    r = _rng(15)
    wqkv = _t(_dyadic(r, (3 * c, c, 1, 1), 1 / 8, 0.25))
    wdw = _t(_dyadic(r, (3 * c, 1, 3, 3), 1 / 2, 0.5))
    wqk, taps = pack_stats(wqkv, wdw, dt)
    c8 = -(-c // 8) * 8
    assert wqk.shape == (2 * c, c8) and taps.shape == (2 * c, 9)
    assert all(t.dtype == dt and t.is_contiguous() for t in (wqk, taps))
    pl = stats_plan(c, heads)
    dh, dhp, hw, nqk, cp, gw, npass = (pl[k] for k in ("dh", "dhp", "hw", "nqk", "cp", "gw", "np"))
    assert dhp % 16 == 0 and dh <= dhp < dh + 16 and hw == 2 * dhp and nqk == heads * hw
    assert gw == pl["hg"] * hw and pl["groups"] * pl["hg"] >= heads and npass % 32 == 0
    assert 7 * npass // 32 <= 48 and pl["nk"] * FRONT_K >= cp  # 3 units of 16 x 32 per warp
    assert pl["bytes"] <= STATS_BUDGET
    # the weight tiles of every pass, as the kernel stages them
    flat = wqk.float().numpy().ravel()
    wt = np.zeros((nqk, pl["nk"] * FRONT_K), np.float32)
    for g0 in range(0, nqk, gw):
        for n0 in range(g0, min(g0 + gw, nqk), npass):
            n = min(npass, min(g0 + gw, nqk) - n0)
            rows = np.array([qk_row(n0 + i, pl, c) for i in range(n)])
            for kt in range(pl["nk"]):
                cols = FRONT_K * kt + np.arange(FRONT_K)
                ok = (rows >= 0)[:, None] & (cols < c8)[None, :]
                wt[n0:n0 + n, cols] = np.where(ok, flat[np.where(ok, rows[:, None] * c8 + cols, 0)], 0)
    want = wqkv[:2 * c].reshape(2 * c, c).to(dt).float().numpy()
    col_rows = np.array([qk_row(n, pl, c) for n in range(nqk)])
    assert sorted(col_rows[col_rows >= 0]) == list(range(2 * c))
    np.testing.assert_array_equal(wt[col_rows >= 0, :c], want[col_rows[col_rows >= 0]])
    assert not wt[col_rows < 0].any() and not wt[:, c:].any()
    flat_t = taps.float().numpy().ravel()
    tp = np.array([[flat_t[k * 9 + tap] if k >= 0 else 0 for k in col_rows] for tap in range(9)])
    np.testing.assert_array_equal(tp[:, col_rows >= 0],
                                  wdw[:2 * c].reshape(2 * c, 9).t().to(dt).float().numpy()[
                                      :, col_rows[col_rows >= 0]])
    assert not tp[:, col_rows < 0].any()
    # the tile on a shifted 16x24 image in 4 parts
    h, w, shift, n_parts = 16, 24, 4, 4
    x = _t(_dyadic(r, (1, h, w, c), 1 / 4, 0.25)).to(dt)
    xf = x.float().numpy()[0]
    tiles = (h // 8) * (w // 8)
    parts = np.zeros((n_parts, c * dh + 2 * c), np.float32)
    for ip in range(n_parts):
        gacc = np.zeros((heads, dhp, dhp), np.float32)
        nacc = np.zeros(nqk, np.float32)
        for t in range(ip * tiles // n_parts, (ip + 1) * tiles // n_parts):
            ty, tx = divmod(t, w // 8)
            halo = np.zeros((FRONT_ROWS, cp), np.float32)
            for p in range(100):
                ur, uc = ty * 8 + p // 10 - 1, tx * 8 + p % 10 - 1
                if 0 <= ur < h and 0 <= uc < w:
                    halo[p, :c] = xf[(ur - shift) % h, (uc - shift) % w]
            t1 = halo @ wt[:, :cp].T
            assert not t1[100:].any() and not t1[:, col_rows < 0].any()
            t1 = torch.from_numpy(t1[:100]).to(dt).float().numpy().reshape(10, 10, nqk)
            qk = np.zeros((64, nqk), np.float32)
            for tap in range(9):
                qk += (t1[tap // 3:tap // 3 + 8, tap % 3:tap % 3 + 8] * tp[tap]).reshape(64, nqk)
            qk = torch.from_numpy(qk).to(dt).float().numpy()
            for hh in range(heads):
                q, k = qk[:, hh * hw:hh * hw + dhp], qk[:, hh * hw + dhp:(hh + 1) * hw]
                gacc[hh] += q.T @ k
            nacc += (qk * qk).sum(axis=0)
        nq = nacc.reshape(heads, hw)
        parts[ip] = np.concatenate([gacc[:, :dh, :dh].ravel(), nq[:, :dh].ravel(),
                                    nq[:, dhp:dhp + dh].ravel()])
    tot = parts[0]
    for ip in range(1, n_parts):
        tot = tot + parts[ip]
    gram, nq, nk = spectral_stats_plain(x, wqkv, wdw, heads, shift=shift)
    assert np.abs(gram.numpy()).max() > 0
    for got, ref in ((tot[:c * dh], gram), (tot[c * dh:c * dh + c], nq), (tot[c * dh + c:], nk)):
        np.testing.assert_allclose(got, ref.numpy().ravel(), rtol=1e-5, atol=0)


def test_gdfn_with_exit_projection_matches_pallas():
    """fused_ln_gdfn_nhwc with residual + proj_w (K5, PromptFusion's exit),
    with a nonzero LN bias so the post-LN halo zeroing is exercised."""
    c, hid, co = 16, 42, 8
    rng = _rng(4)
    x = _n(rng, (1, 24, 16, c))
    ln_w, ln_b = 1 + _n(rng, (c,), 0.1), _n(rng, (c,), 0.5)
    w_in, w_dw = _u(rng, (1, 1, c, 2 * hid), c), _u(rng, (3, 3, 1, 2 * hid), 9)
    w_out, proj = _u(rng, (1, 1, hid, c), hid), _u(rng, (1, 1, c, co), c)
    want = PA.fused_ln_gdfn_nhwc(
        jnp.asarray(x), jnp.asarray(ln_w), jnp.asarray(ln_b), jnp.asarray(w_in),
        jnp.asarray(w_dw), jnp.asarray(w_out), residual=True, proj_w=jnp.asarray(proj),
        interpret=True)
    got = gdfn_plain(_t(x), _t(ln_w), _t(ln_b), _oihw(w_in), _oihw(w_dw), _oihw(w_out),
                     residual=True, proj_w=_oihw(proj))
    _close(got, want)


def test_wrappers_take_plain_version_on_cpu_and_refuse_other_devices():
    """A CPU tensor runs the plain version and launches nothing; a tensor on
    a device without a kernel raises instead of falling back."""
    _route.reset_counters()
    x = torch.zeros(1, 8, 8, 4)
    w = torch.zeros(4, 4, 3, 3)
    assert torch.equal(conv3(x, w), conv3_plain(x, w))
    assert _route.COUNTERS["conv3"].launches == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        conv3(x.to("meta"), w.to("meta"))
