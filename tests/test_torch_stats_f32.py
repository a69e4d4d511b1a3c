"""The float32 spectral stats tile (K2 phase 0 and K3's spectral half in
float32, ``spectral_stats_f32_kernel`` in csrc/spectral_stats_f32.cuh:
3xTF32 on m16n8k8) without a card: the plan mirror ``stats_f32_plan`` at
every width, and the tile emulated in numpy from its own tile map (per 8x8
tile of the unrolled frame, the 10x10 halo with LN in float32 padded to 112
rows and to 32-channel chunks; per column group the 1x1 against
``pack_stats``' float32 q|k rows in the head-grouped order, k8 step by k8
step with the three TF32 products summed toward zero and added in float32;
the depthwise 3x3 by fmaf in tap order; each head's Gram q_h^T k_h in k8
pixel steps; the norms by 8 lanes a column and a butterfly; the per-tile
sums added per block range, then over the parts in order) against
``spectral_stats_plain`` in float32 at every (C, heads) of the presets and
the odd widths, unshifted, shifted and as the PromptFusion entry (x2 + LN);
three planted faults the check must catch; a row shard's halo rows at
every edge-flag combination (LN'd like the map, zero at an image edge),
with rows swapped top for bottom as a planted fault; a member's head block
under the spectral mesh axis (q|k width CL = C / 2 from the weight, 2 of
the members at every preset width, with and without halo rows), with its k
rows read at the whole attention's offset C as a planted fault; one case
against the JAX package's merged window + stats kernel in interpret mode. The kernel itself
is held against the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py. Imports JAX only in the test that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.kernels.spectral import (
    F32_K, STATS_BUDGET, STATS_F32_STATIC, Halo, pack_stats, qk_row, spectral_stats_plain,
    stats_f32_plan,
)
from tf32_emulation import mma
from torch_port_inputs import normal as _n, rng as _rng, tensor as _t
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, heads) of every float32 stats call of the presets (dh 32, 64, 48, 96;
# the PromptFusion widths 128/4, 256/8, 192/4, 384/8 among them) and the odd
# widths: dh 18 and 9 (rows not 16-byte multiples), C = 400 (dh 50 padded to
# 64, 8 groups of one head)
WIDTHS = [(64, 2), (128, 4), (128, 2), (256, 8), (96, 2), (192, 4), (384, 8), (192, 2), (36, 2),
          (27, 3), (400, 8)]
# (groups, heads a group, ring stages, bytes with the static)
PLANS = {(64, 2): (1, 2, 3, 153152), (128, 4): (2, 2, 3, 153152), (128, 2): (2, 1, 3, 161344),
         (256, 8): (3, 3, 3, 203840), (96, 2): (1, 2, 3, 209984), (192, 4): (2, 2, 3, 209984),
         (384, 8): (4, 2, 3, 209984), (192, 2): (2, 1, 3, 228416), (36, 2): (1, 2, 3, 153152),
         (27, 3): (1, 3, 3, 124736), (400, 8): (8, 1, 3, 161344)}
LIMIT = 232448  # the H100's shared memory per block (opt-in)
EPS = 1e-5
TOL = 2e-6  # of each output's max-abs: float32 both sides, sums in other orders
PARTS = 4   # blocks per image over the 6 tiles of a 16x24 map: ranges 1, 2, 1, 2
HALO_EDGES = [(True, True), (True, False), (False, True), (False, False)]


def _fma(acc, a, b):
    """fmaf(a, b, acc) elementwise in float32 (the product exact)."""
    return (acc.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def _tiles(u, rows=None):
    """(B, H, W, C) -> the 10x10 halos of the 8x8 tiles, (B, T, 100, C),
    tiles in row-major order, zero outside the image; ``rows``: the (top,
    bottom) rows (B, 1, W, C) beyond the map's first and last rows."""
    b, h, w, c = u.shape
    up = np.zeros((b, h + 2, w + 2, c), np.float32)
    up[:, 1:-1, 1:-1] = u
    if rows is not None:
        up[:, :1, 1:-1], up[:, -1:, 1:-1] = rows
    return np.stack([up[:, 8 * ty:8 * ty + 10, 8 * tx:8 * tx + 10].reshape(b, 100, c)
                     for ty in range(h // 8) for tx in range(w // 8)], axis=1)


def _emulate(x, wqkv, wdw, heads, shift=0, x2=None, ln_w=None, ln_b=None, halo=None,
             three=True, chained=False, swapped=False, halo_swapped=False, k_at_c=False):
    """The tile on x (B, H, W, C1) [and x2] float32: (gram (B, CL, dh), nq,
    nk (B, heads, dh)), CL = wqkv.shape[0] / 3. three=False: one TF32
    product; chained: the products summed on the tensor cores across all of
    K; swapped: q and k trade places within each head; halo_swapped: the
    halo rows staged top for bottom; k_at_c: a head block's k rows read at
    the offset C (the planted faults)."""
    u = np.roll(x.numpy(), (shift, shift), axis=(1, 2)) if shift else x.numpy()
    if x2 is not None:
        u = np.concatenate([u, x2.numpy()], axis=-1)

    def norm(t):
        if ln_w is None:
            return t
        mu = t.mean(-1, keepdims=True)
        rs = np.float32(1) / np.sqrt(((t - mu) ** 2).mean(-1, keepdims=True) + np.float32(EPS))
        return (t - mu) * rs * ln_w.numpy() + ln_b.numpy()

    u = norm(u)
    b, h, w, c = u.shape
    rows = None
    if halo is not None:  # the rows beyond the shard: LN'd as the map, zero at an image edge
        rows = [np.zeros((b, 1, w, c), np.float32) if edge else norm(r.numpy())
                for r, edge in ((halo.top, halo.edge_top), (halo.bot, halo.edge_bot))]
        rows = rows[::-1] if halo_swapped else rows
    cl = wqkv.shape[0] // 3
    pl = stats_f32_plan(c, heads, cl)
    dh, dhp, hw, gw_max = pl["dh"], pl["dhp"], pl["hw"], pl["gw"]
    ck = F32_K * pl["nk"]
    halo = np.zeros((b, (h // 8) * (w // 8), 112, ck), np.float32)
    halo[:, :, :100, :c] = _tiles(u, rows)
    wq, taps = (t.numpy() for t in pack_stats(wqkv, wdw, torch.float32))
    n_tiles = halo.shape[1]
    gram = np.zeros((b, n_tiles, heads, dhp, dhp), np.float32)
    norm = np.zeros((b, n_tiles, pl["nqk"]), np.float32)
    for g0 in range(0, pl["nqk"], gw_max):
        gw = min(gw_max, pl["nqk"] - g0)
        rows = [qk_row(g0 + n, pl, c if k_at_c else cl) for n in range(gw)]
        wg = np.zeros((gw, ck), np.float32)
        tg = np.zeros((9, gw), np.float32)
        for n, r in enumerate(rows):
            if 0 <= r < wq.shape[0]:
                wg[n, :wq.shape[1]] = wq[r]
                tg[:, n] = taps[r]
        t = mma(np.zeros((b, n_tiles, 112, gw), np.float32), halo, wg.T, three, chained)
        t = t[:, :, :100].reshape(b, n_tiles, 10, 10, gw)
        qk = np.zeros((b, n_tiles, 8, 8, gw), np.float32)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            qk = _fma(qk, t[:, :, dy:dy + 8, dx:dx + 8], tg[tap])
        qk = qk.reshape(b, n_tiles, 64, gw)
        for hh in range(gw // hw):
            q = qk[..., hh * hw:hh * hw + dhp]
            k = qk[..., hh * hw + dhp:(hh + 1) * hw]
            if swapped:
                q, k = k, q
            gram[:, :, (g0 // hw) + hh] = mma(np.zeros((b, n_tiles, dhp, dhp), np.float32),
                                              q.swapaxes(-1, -2), k, three, chained)
        lanes = np.zeros((b, n_tiles, 8, gw), np.float32)
        for i in range(8):  # lane e: pixels e, e + 8, ..
            v = qk[:, :, 8 * i:8 * i + 8]
            lanes = _fma(lanes, v, v)
        s = lanes
        for m in (1, 2, 4):  # the butterfly: lane e adds lane e ^ m
            s = s + s[:, :, np.arange(8) ^ m]
        norm[..., g0:g0 + gw] = s[:, :, 0]
    # the blocks' partial sums over their tile ranges, then the parts in order
    out_g = np.zeros((b, heads, dhp, dhp), np.float32)
    out_n = np.zeros((b, pl["nqk"]), np.float32)
    for ip in range(PARTS):
        pg = np.zeros_like(out_g)
        pn = np.zeros_like(out_n)
        for t_ in range(ip * n_tiles // PARTS, (ip + 1) * n_tiles // PARTS):
            pg = pg + gram[:, t_]
            pn = pn + norm[:, t_]
        out_g = out_g + pg
        out_n = out_n + pn
    out_n = out_n.reshape(b, heads, 2, dhp)
    return (out_g[:, :, :dh, :dh].reshape(b, cl, dh), out_n[:, :, 0, :dh], out_n[:, :, 1, :dh])


def _inputs(variant, c, heads, seed, h=16, w=24):
    """(args, kwargs) of one spectral_stats_plain call of the variant, float32:
    a block's stats at shift 0 or 4, or the PromptFusion entry (x2 + LN, C
    split in halves)."""
    r = _rng(seed)
    wq = _t(_n(r, (3 * c, c, 1, 1), c ** -0.5))
    wd = _t(_n(r, (3 * c, 1, 3, 3), 1 / 3))
    x = _t(_n(r, (1, h, w, c)))
    if variant == "fusion":
        return [x[..., :c // 2].contiguous(), wq, wd, heads], dict(
            x2=x[..., c // 2:].contiguous(), ln_w=1 + _t(_n(r, (c,), 0.1)),
            ln_b=_t(_n(r, (c,), 0.1)))
    return [x, wq, wd, heads], dict(shift=0 if variant == "shift0" else 4)


def _rel(got, ref):
    return max(float(np.abs(g - r).max()) / float(np.abs(r).max()) for g, r in zip(got, ref))


def _case(variant, c, heads, edges=None, member=None, **faults):
    """(emulated, plain) of one call; ``edges``: with halo rows drawn from
    the seed, these edge flags (the call read in its own frame, shift 0);
    ``member``: that member's head block of 2 (half the heads, their q|k|v
    rows of the weights)."""
    args, kw = _inputs(variant, c, heads, 300 + c + heads)
    if member is not None:
        from mp_hsir_tpu_torch.parallel.tp import qkv_rows

        cl = c // 2
        args = [args[0], qkv_rows(args[1], c, cl, member), qkv_rows(args[2], c, cl, member),
                heads // 2]
    if edges is not None:
        r = _rng(400 + c)
        w = args[0].shape[2]
        kw = dict(kw, shift=0, halo=Halo(_t(_n(r, (1, 1, w, c))), _t(_n(r, (1, 1, w, c))), *edges))
    got = _emulate(*args, **kw, **faults)
    ref = tuple(t.numpy() for t in spectral_stats_plain(*args, **kw))
    return got, ref


@pytest.mark.parametrize("c,heads", WIDTHS)
def test_stats_f32_plan(c, heads):
    """The plan mirror at every width: groups, heads a group, ring stages
    and bytes (static included) as pinned; within the device's limit; every
    group holds whole heads of at most 192 columns, and the groups cover
    all heads."""
    pl = stats_f32_plan(c, heads)
    assert (pl["groups"], pl["hg"], pl["ws"], pl["bytes"]) == PLANS[(c, heads)]
    assert pl["ok"] and pl["bytes"] <= LIMIT and pl["dyn"] <= STATS_BUDGET
    assert pl["bytes"] == pl["dyn"] + STATS_F32_STATIC
    assert pl["gw"] == pl["hg"] * pl["hw"] <= 192 and pl["gw"] % 32 == 0
    assert (pl["groups"] - 1) * pl["hg"] < heads <= pl["groups"] * pl["hg"]
    assert pl["ldq"] % 32 == 8 and pl["dhp"] % 16 == 0


def test_stats_f32_plan_without_a_fit():
    """Heads wider than 96 (a head's q|k columns past one group of 192)
    have no plan: the wrapper raises there."""
    assert not stats_f32_plan(256, 2)["ok"]
    assert stats_f32_plan(192, 2)["ok"]


@pytest.mark.parametrize("variant", ["shift0", "shift4", "fusion"])
@pytest.mark.parametrize("c,heads", WIDTHS)
def test_stats_f32_emulation_matches_plain(variant, c, heads):
    """The emulated tile against spectral_stats_plain in float32 on one
    16x24 map (6 tiles over 4 parts): the Gram, |q|^2 and |k|^2 within 2e-6
    of each one's max-abs."""
    got, ref = _case(variant, c, heads)
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("edges", HALO_EDGES, ids=lambda e: f"edge{int(e[0])}{int(e[1])}")
@pytest.mark.parametrize("variant,c,heads", [("shift0", 64, 2), ("fusion", 64, 2),
                                             ("shift0", 27, 3)])
def test_stats_f32_emulation_with_halo_rows_matches_plain(variant, c, heads, edges):
    """A row shard (K7a): the emulated tile with the rows above and below
    the map as its halo's first and last rows (LN'd like the map; zero where
    the flag says image edge) against spectral_stats_plain with the same
    Halo, within 2e-6 of each output's max-abs; nothing is summed over the
    halo rows."""
    got, ref = _case(variant, c, heads, edges)
    assert _rel(got, ref) <= TOL, _rel(got, ref)


def test_stats_f32_emulation_sees_swapped_halo_rows():
    """The halo check is not blind: the rows staged top for bottom break the
    bound (both rows real)."""
    got, ref = _case("fusion", 64, 2, (False, False), halo_swapped=True)
    assert _rel(got, ref) > TOL, _rel(got, ref)


@pytest.mark.parametrize("fault", [dict(three=False), dict(chained=True), dict(swapped=True)],
                         ids=["one-tf32-product", "chained-k8-sums", "q-k-swapped"])
def test_stats_f32_emulation_sees_the_faults(fault):
    """The check is not blind: one TF32 product instead of three (10-bit
    operands), the k8 steps' sums chained on the tensor cores (each add
    truncated) instead of flushed into float32, and q and k swapped within
    each head (the transposed Gram) each break the bound at C = 400."""
    got, ref = _case("shift4", 400, 8, **fault)
    assert _rel(got, ref) > TOL, _rel(got, ref)


# (C, heads) of the presets' spectral attentions whose heads a spectral axis of
# 2 divides (the flagship's PGSSTB and PromptFusion widths, the remote-sensing
# preset's): each member's block is C / 2 wide
TP_WIDTHS = [(64, 2), (128, 4), (256, 8), (96, 2), (192, 4), (384, 8)]


@pytest.mark.parametrize("member", [0, 1])
@pytest.mark.parametrize("c,heads", TP_WIDTHS)
def test_stats_f32_head_block_plan_and_emulation(c, heads, member):
    """A member's head block (q|k width CL = C / 2, heads / 2 heads; the
    1x1 still C deep): its plan no larger than the whole attention's, and the
    emulated tile against spectral_stats_plain on the member's weight rows
    within 2e-6 of each output's max-abs, with interior halo rows for member
    1."""
    pl, whole = stats_f32_plan(c, heads // 2, c // 2), stats_f32_plan(c, heads)
    assert pl["ok"] and pl["nk"] == whole["nk"] and pl["bytes"] <= whole["bytes"]
    got, ref = _case("shift0", c, heads, (False, False) if member else None, member=member)
    assert got[0].shape == ref[0].shape == (1, c // 2, c // heads)
    assert _rel(got, ref) <= TOL, _rel(got, ref)


def test_stats_f32_head_block_emulation_sees_the_wrong_offset():
    """The head-block check is not blind: the k rows read at the whole
    attention's offset C (the member's v rows) break the bound."""
    got, ref = _case("shift0", 128, 4, member=1, k_at_c=True)
    assert _rel(got, ref) > TOL, _rel(got, ref)


@pytest.mark.parametrize("shifted", [False, True])
def test_stats_f32_emulation_matches_pallas_interpret(shifted):
    """The emulated tile on the window output of the JAX package's merged
    K3 kernel (fused_ln_window_attention_nhwc with sp_qk, interpret mode,
    float32) against that kernel's own Gram and norms (outs[2:]), at the
    tolerance tests/test_torch_kernels.py holds the plain version to."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops import pallas_attention as PA
    from mp_hsir_tpu_torch.ops.window import shifted_region_map
    from torch_port_inputs import window_inputs

    c, heads, h, w = 16, 2, 24, 32
    d = window_inputs(0, c, heads, h, w)
    region = jnp.asarray(shifted_region_map(h, w, 8, 4)) if shifted else None
    outs = PA.fused_ln_window_attention_nhwc(
        jnp.asarray(d["x"]), jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"]),
        jnp.asarray(d["wqkv"]), jnp.asarray(d["bqkv"]), jnp.asarray(d["rel_bias"]),
        jnp.asarray(d["wp"]), jnp.asarray(d["bp"]), region, heads, shift_in=shifted,
        sp_qk=(jnp.asarray(d["wqkv_sp"]), jnp.asarray(d["wdw_sp"]), heads), interpret=True)
    wqkv = _t(d["wqkv_sp"]).t().reshape(3 * c, c, 1, 1)
    wdw = _t(d["wdw_sp"]).t().reshape(3 * c, 1, 3, 3)
    got = _emulate(_t(np.asarray(outs[0])), wqkv, wdw, heads, shift=4 if shifted else 0)
    for g, want in zip(got, outs[2:]):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-3, rtol=1e-4)
