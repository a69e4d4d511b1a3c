"""The bf16 spectral stats backward (K10a) without a card: the plan mirror
``stats_bwd_tc_plan``, and both of its tiles emulated in numpy from their
own tile maps (launch 1, ``spectral_stats_bwd_tc_kernel``: the head-grouped
q|k columns with dh padded to dhp in groups and passes, dG staged
[nH][dhp][dhp], dq | dk per head; launch 2, ``dwconv_dx_tc_kernel``: the
64-channel stencil chunks, dxn summed over the chunks, the LayerNorm
epilogue and the roll-back, the per-tile partials, emulated in
tests/dwconv_dx_emulation.py) and the wrapper's weight
product and in-order sums, at the rounding points of
``spectral_stats_bwd_plain``, against it, on the whole attention and on a
member's head block (q|k width CL < C, K = 2CL); one tiny case against JAX's
``_sp0_bwd_call`` in interpret mode. The kernels themselves are held against
the plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
Imports JAX only in the test that compares with it."""

import numpy as np
import pytest
import torch

from dwconv_dx_emulation import (
    halo_row_out as _halo_row_out, halo_rows_bwd as _halo_rows_bwd, halo_taps as _halo_taps,
    interior as _interior, launch2 as _launch2, ln as _ln, rnd as _rnd, tiles as _tiles,
    untile as _untile,
)
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    DX_LDD, DX_LDT, STATS_BUDGET, Halo, pack_stats, qk_row, spectral_stats,
    spectral_stats_bwd_plain, stats_bwd_tc_plan, stats_plan,
)
from torch_port_inputs import normal as _n, rng as _rng, uniform as _u
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, heads) of every stats call of the presets' train steps (dh 32, 64, 48
# and 96) and C = 36 and 27 (dh 18 and 9, padded to 32 and 16; 2C = 72 and
# 54: the last stencil chunk is ragged)
WIDTHS = [(64, 2), (128, 4), (128, 2), (256, 8), (96, 2), (192, 2), (192, 4), (384, 8), (36, 2),
          (27, 3)]
# the dynamic bytes of both tiles' plans: launch 1 (the forward tile's plan
# with dG in the Gram partial's place) and launch 2 (its ring stages, bytes)
PLANS = {(64, 2): (96768, 3, 161664), (128, 4): (119040, 3, 186240),
         (128, 2): (127232, 3, 186240), (256, 8): (199424, 2, 160000),
         (96, 2): (146816, 3, 186240), (192, 2): (174080, 3, 210816),
         (192, 4): (183296, 3, 210816),
         (384, 8): (188672, 2, 192768), (36, 2): (96768, 3, 161664),
         (27, 3): (68160, 3, 161664)}


def _halo_in(rows, flags, lnw, lnb, dt, eps):
    """A row shard's halo rows as the first tile stages them (the LayerNorm
    in place, rounded): (top, bot) (B, W, C), None at an image edge (a side
    without its bit). rows [2][B][W][C] the raw rows."""
    norm = (lambda a: a) if lnw is None else (lambda a: _rnd(_ln(a, lnw, lnb, eps)[2], dt))
    return tuple(norm(rows[i]) if flags & (1 << i) else None for i in range(2))


def _launch1(x, wq, wd, heads, shift, lnw, lnb, dgram, dnq, dnk, dt, eps, transposed=True,
             hrows=(None, None), k_at=None):
    """The first tile on every 8x8 tile: (un, t, dqk) in the unrolled frame,
    t and dqk in the torch channel order, then un_halo [2][B][W][C] and
    t_halo [2][B][W][2CL]: the LN'd input and 1x1 output of a row shard's
    staged halo rows ``hrows`` (_halo_in), which the first and last tile
    rows write (zero on a side without a row). CL = wq's rows / 2: C, or a
    member's head block of ``heads`` heads. transposed=False computes dq
    with dG instead of dG^T (a planted fault); ``k_at``: the k rows read at
    that offset instead of CL (a planted fault for a head block)."""
    b, h, w, c = x.shape
    cl = wq.shape[0] // 2
    pl = stats_bwd_tc_plan(c, heads, cl)
    dh, dhp, hw, nqk = pl["dh"], pl["dhp"], pl["hw"], pl["nqk"]
    raw = np.roll(x, (shift, shift), axis=(1, 2))
    un = raw if lnw is None else _rnd(_ln(raw, lnw, lnb, eps)[2], dt)
    halo = _tiles(un, *hrows)  # the halo staged as bf16, LN in place, zero outside
    sides = [s for s in range(2) if hrows[s] is not None]
    un_h = np.zeros((2, b, w, c), np.float32)
    t_h = np.zeros((2, b, w, 2 * cl), np.float32)
    for side in sides:
        un_h[side] = _halo_row_out(halo, side, b, h, w)
    rows = np.array([qk_row(n, pl, cl) for n in range(nqk)])
    ok = rows >= 0
    if k_at is not None:  # the weight rows read with k at the wrong offset (clipped)
        read = np.array([min(qk_row(n, pl, k_at), 2 * cl - 1) if r >= 0 else 0
                         for n, r in enumerate(rows)])
    else:
        read = np.maximum(rows, 0)
    wg = np.where(ok[:, None], wq[read, :c], 0)  # [nqk][C]
    tg = np.where(ok[:, None], wd[read], 0)      # [nqk][9]
    dg = np.zeros((b, heads, dhp, dhp), np.float32)
    dg[:, :, :dh, :dh] = _rnd(dgram.reshape(b, heads, dh, dh), dt)
    dn = np.zeros((b, heads, 2, dhp), np.float32)
    dn[:, :, 0, :dh], dn[:, :, 1, :dh] = dnq, dnk
    t_out = np.zeros(halo.shape[:3] + (64, 2 * cl), np.float32)
    dqk = np.zeros_like(t_out)
    for g in range(pl["groups"]):
        g0 = g * pl["gw"]
        gw = min(pl["gw"], nqk - g0)
        qk = np.zeros(halo.shape[:3] + (64, gw), np.float32)
        for n0 in range(0, gw, pl["np"]):  # the passes of up to np columns
            cols = np.arange(g0 + n0, g0 + min(n0 + pl["np"], gw))
            t = _rnd(halo @ wg[cols].T, dt)  # [..., 100, np]
            t_out[..., rows[cols[ok[cols]]]] = _interior(t)[..., ok[cols]]
            for side in sides:
                t_h[side][..., rows[cols[ok[cols]]]] = _halo_row_out(t, side, b, h, w)[
                    ..., ok[cols]]
            t10 = t.reshape(*t.shape[:-2], 10, 10, len(cols))
            acc = np.zeros(t.shape[:-2] + (8, 8, len(cols)), np.float32)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                acc += t10[..., dy:dy + 8, dx:dx + 8, :] * tg[cols, tap]
            qk[..., cols - g0] = _rnd(acc.reshape(*acc.shape[:-3], 64, len(cols)), dt)
        for hh in range(gw // hw):  # dq_h = k_h dG_h^T, dk_h = q_h dG_h, K = dhp
            hd = g * pl["hg"] + hh
            q, k = qk[..., hh * hw:hh * hw + dhp], qk[..., hh * hw + dhp:(hh + 1) * hw]
            gh = dg[:, hd][:, None, None]
            gq = np.swapaxes(gh, -1, -2) if transposed else gh
            dq = k @ gq + 2 * q * dn[:, hd, 0][:, None, None, None]
            dk = q @ gh + 2 * k * dn[:, hd, 1][:, None, None, None]
            for side, v in ((0, dq), (1, dk)):
                n = g0 + hh * hw + side * dhp + np.arange(dh)
                dqk[..., rows[n]] = v[..., :dh]
    return (un, _untile(t_out.reshape(-1, 64, 2 * cl), b, h, w),
            _untile(dqk.reshape(-1, 64, 2 * cl), b, h, w), un_h, t_h)


def _emulate(x, wqkv, wdw, heads, shift, ln_w, ln_b, eps, dgram, dnq, dnk, transposed=True,
             halo=None, fault=""):
    """Both tiles, the weight product and the in-order partial sums: the
    outputs of spectral_stats_bwd_plain as numpy arrays. ``halo``: a row
    shard's :class:`Halo` (shift 0); then also grad.cu's halo-row kernel and
    the wrapper's halo-row backward, and the outputs end with d top, d bot.
    Planted faults on a shard: "swapped" (the halo rows top for bottom),
    "edge" (the top edge flag inverted), "no_taps" (the halo rows' tap
    partials left out); on a head block (CL = wqkv.shape[0] / 3 < C):
    "k_at_c" (the k rows read at offset C instead of CL)."""
    dt = x.dtype
    c = x.shape[-1]
    cl = wqkv.shape[0] // 3
    wq, wd = (a.float().numpy() for a in pack_stats(wqkv, wdw, dt))
    lnw = None if ln_w is None else ln_w.float().numpy()
    lnb = None if ln_b is None else ln_b.float().numpy()
    xf = x.float().numpy()
    flags, rows, hrows = 0, None, (None, None)
    if halo is not None:
        rows = np.stack([halo.top[:, 0].float().numpy(), halo.bot[:, 0].float().numpy()])
        if fault == "swapped":
            rows = rows[::-1].copy()
        flags = halo.flags ^ (1 if fault == "edge" else 0)
        hrows = _halo_in(rows, flags, lnw, lnb, dt, eps)
    un, t, dqk, un_h, t_h = _launch1(xf, wq, wd, heads, shift, lnw, lnb, dgram.numpy(),
                                     dnq.numpy(), dnk.numpy(), dt, eps, transposed, hrows,
                                     c if fault == "k_at_c" else None)
    dtt, dx, part = _launch2(xf, dqk, t, wd, wq, lnw, shift, dt, eps)
    tot = np.zeros(part.shape[1], np.float32)
    for row in part:  # sum_parts: the tiles in order
        tot += row
    k = 2 * cl
    dw = np.zeros((3 * cl, c), np.float32)
    dw[:k] = dtt.reshape(-1, k).T @ un.reshape(-1, c)
    taps = tot[:9 * k].reshape(9, k)
    dln = (tot[9 * k:9 * k + c], tot[9 * k + c:]) if ln_w is not None else (None, None)
    dtop = dbot = None
    if halo is not None:
        dth, dwh = _halo_taps(dqk, t_h, wd, flags, dt, fault)
        taps[:3] += dwh[0]
        taps[6:] += dwh[1]
        dtop, dbot, dw_h, dln_h = _halo_rows_bwd(dth, wq, rows, lnw, eps, flags, un_h, dt)
        dw[:k] += dw_h
        if dln_h is not None:
            dln = tuple(a + e for a, e in zip(dln, dln_h))
    dwdw = np.zeros((3 * cl, 9), np.float32)
    dwdw[:k] = taps.T
    out = (dx, dw.reshape(3 * cl, c, 1, 1), dwdw.reshape(3 * cl, 1, 3, 3), *dln)
    return out if halo is None else out + (dtop, dbot)


def _inputs(c, heads, dt, seed, ln, b=2, h=8, w=16, cl=None):
    """One call's operands; ``cl``: a member's head block of ``heads``
    heads (wqkv (3CL, C), dgram (B, CL, dh)) instead of the whole
    attention."""
    r = _rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(_n(r, s, scale))  # noqa: E731
    cl = c if cl is None else cl
    dh = cl // heads
    x = f(b, h, w, c).to(dt)
    wqkv, wdw = torch.from_numpy(_u(r, (3 * cl, c, 1, 1), c)), torch.from_numpy(
        _u(r, (3 * cl, 1, 3, 3), 9))
    lnw, lnb = (1 + f(c, scale=0.1), f(c, scale=0.1)) if ln else (None, None)
    return (x, wqkv, wdw, heads, lnw, lnb, f(b, cl, dh, scale=0.05), f(b, heads, dh, scale=0.05),
            f(b, heads, dh, scale=0.05))


def _errs(got, ref):
    out = []
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        r = r.float().numpy()
        assert g.shape == r.shape, (g.shape, r.shape)
        out.append((float(np.abs(g - r).max()), float(np.abs(r).max())))
    return out


def _case(c, heads, shift, ln, dt, transposed=True):
    x, wqkv, wdw, nh, lnw, lnb, dg, dq, dk = _inputs(c, heads, dt, 60 + c + heads, ln)
    got = _emulate(x, wqkv, wdw, nh, shift, lnw, lnb, 1e-5, dg, dq, dk, transposed)
    ref = spectral_stats_bwd_plain(x, wqkv, wdw, nh, shift, lnw, lnb, 1e-5, dg, dq, dk)
    return _errs(got, ref)


@pytest.mark.parametrize("c,heads", WIDTHS)
def test_stats_bwd_tc_plan(c, heads):
    """The plan mirror: launch 1 keeps the forward tile's groups, passes and
    ring and takes at most its bytes (dG bf16 in the float32 Gram partial's
    place); launch 2 takes 3 ring stages where they fit (2 at C = 256 and
    384), every chunk of the 2C channels; both within the budget."""
    pl, fwd = stats_bwd_tc_plan(c, heads), stats_plan(c, heads)
    one, stages, two = PLANS[c, heads]
    assert pl["bytes"] == one and pl["bytes"] <= fwd["bytes"] <= STATS_BUDGET
    assert {k: pl[k] for k in fwd if k != "bytes"} == {k: v for k, v in fwd.items() if k != "bytes"}
    assert pl["ldg"] == pl["dhp"] + 8 and pl["dhp"] % 16 == 0
    dx = pl["dx"]
    assert (dx["stages"], dx["bytes"]) == (stages, two) and two <= STATS_BUDGET
    if stages == 2:
        assert two + dx["stage"] > STATS_BUDGET
    assert dx["nck"] * 64 >= 2 * c > (dx["nck"] - 1) * 64
    assert dx["stage"] == 4 * 100 * DX_LDD + 2 * 100 * DX_LDT + 2 * 64 * (dx["ck"] + 8)


@pytest.mark.parametrize("c,heads", WIDTHS)
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_stats_bwd_tiles_emulation_matches_plain(c, heads, shift, ln, dt):
    """Both tiles emulated from their tile maps on 2 images of 8x16 (4 tiles,
    the roll-back wrapping at shift 4) against spectral_stats_bwd_plain, every
    output. float32: the same arithmetic in other orders, 1e-4 of each
    output's max-abs. bf16: the same rounding points (q, k, dG, dtt, dx),
    where a float32 sum in another order can flip one rounding: 3e-2."""
    tol = 3e-2 if dt == torch.bfloat16 else 1e-4
    for i, (err, mx) in enumerate(_case(c, heads, shift, ln, dt)):
        assert mx > 0 and err <= tol * mx, f"output {i}: {err:.3e} > {tol} * {mx:.3e}"


EDGES = [(True, True), (True, False), (False, True), (False, False)]


def _halo_case(c, heads, ln, edges, fault="", seed=0):
    """A row shard of one tile row (2 images of 8 x 16) with its bf16 halo
    rows: (emulation errors against spectral_stats_bwd_plain, every output
    both have; whether both give the halo cotangents at the same sides)."""
    x, wqkv, wdw, nh, lnw, lnb, dg, dq, dk = _inputs(c, heads, torch.bfloat16, 90 + c + seed, ln)
    r = _rng(7 + seed)
    top, bot = (torch.from_numpy(_n(r, (2, 1, 16, c))).to(torch.bfloat16) for _ in range(2))
    halo = Halo(top, bot, *edges)
    got = _emulate(x, wqkv, wdw, nh, 0, lnw, lnb, 1e-5, dg, dq, dk, halo=halo, fault=fault)
    ref = spectral_stats_bwd_plain(x, wqkv, wdw, nh, 0, lnw, lnb, 1e-5, dg, dq, dk, halo=halo)
    same = all((g is None) == (r is None) for g, r in zip(got[-2:], ref[-2:]))
    pairs = [(g, r) for g, r in zip(got, ref) if g is not None and r is not None]
    return _errs(*zip(*pairs)), same


@pytest.mark.parametrize("c,heads", [(64, 2), (27, 3)])
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("edges", EDGES, ids=lambda e: f"edge{int(e[0])}{int(e[1])}")
def test_stats_bwd_halo_emulation_matches_plain(c, heads, ln, edges):
    """On a bf16 row shard with its halo rows (the first tile staging them
    through the halo source map, writing their LN'd input and 1x1 output;
    grad.cu's halo-row kernel adding their cotangents and tap partials; the
    wrapper's halo-row backward through the 1x1 and the LayerNorm) against
    spectral_stats_bwd_plain with the same Halo: every output, d top and d
    bottom included, within the bf16 bound 3e-2 of its max-abs, and the
    halo cotangents at the same sides."""
    errs, same = _halo_case(c, heads, ln, edges)
    assert same
    for i, (err, mx) in enumerate(errs):
        assert err <= 3e-2 * mx, f"output {i}: {err:.3e} > 3e-2 * {mx:.3e}"


@pytest.mark.parametrize("fault", ["swapped", "edge", "no_taps"])
def test_stats_bwd_halo_emulation_sees_planted_faults(fault):
    """The halo check is not blind: the halo rows swapped top for bottom,
    the top edge flag inverted (the image edge's wrapped row taken as real)
    and the halo rows' tap partials left out each move an output past the
    bf16 bound (or put a halo cotangent at the wrong side)."""
    edges = (True, False) if fault == "edge" else (False, False)
    errs, same = _halo_case(64, 2, True, edges, fault)
    assert not same or any(err > 3e-2 * mx for err, mx in errs), errs


@pytest.mark.parametrize("c,heads", [(64, 2), (27, 3)])
def test_stats_bwd_emulation_sees_the_transpose(c, heads):
    """The check is not blind to dG's orientation: dq computed with dG
    instead of dG^T moves dx and d wqkv past the bf16 bound."""
    errs = _case(c, heads, 4, True, torch.bfloat16, transposed=False)
    assert all(errs[i][0] > 3e-2 * errs[i][1] for i in (0, 1)), errs


# a member's head block under the spectral mesh axis, bf16: (C, heads of the
# member, CL) at CL = C / 2 and C / 4 of the presets' widths, CL = 48 (the
# remote-sensing preset's C = 96 on two members: not a multiple of 32) and
# an odd one (C = 36, CL = 18)
HEAD_BLOCKS = [(64, 1, 32), (128, 2, 64), (128, 1, 32), (96, 1, 48), (192, 1, 96), (192, 1, 48),
               (36, 1, 18)]


def _head_block_case(c, heads, cl, shift=0, edges=None, fault=""):
    """A member's bf16 head block (the q|k rows of its heads, dgram (B, CL,
    dh)): the emulation's errors against spectral_stats_bwd_plain, every
    output (with ``edges``: a row shard's halo rows, d top and d bot too)."""
    x, wqkv, wdw, nh, lnw, lnb, dg, dq, dk = _inputs(c, heads, torch.bfloat16, 70 + c + cl, False,
                                                     cl=cl)
    halo = None
    if edges is not None:
        r = _rng(8 + cl)
        top, bot = (torch.from_numpy(_n(r, (2, 1, 16, c))).to(torch.bfloat16) for _ in range(2))
        halo = Halo(top, bot, *edges)
    got = _emulate(x, wqkv, wdw, nh, shift, lnw, lnb, 1e-5, dg, dq, dk, halo=halo, fault=fault)
    ref = spectral_stats_bwd_plain(x, wqkv, wdw, nh, shift, lnw, lnb, 1e-5, dg, dq, dk, halo=halo)
    pairs = [(g, r) for g, r in zip(got, ref) if g is not None and r is not None]
    return _errs(*zip(*pairs))


@pytest.mark.parametrize("c,heads,cl", HEAD_BLOCKS)
@pytest.mark.parametrize("rows", ["whole", "interior"])
def test_stats_bwd_head_block_emulation_matches_plain(c, heads, cl, rows):
    """Both bf16 tiles on a member's head block (the first at q|k width CL:
    its head groups, t and dqk 2CL wide; the second at K = 2CL; the weight
    cotangents (3CL, C)), on the whole map at shift 4 and on a row shard
    with interior halo rows, against spectral_stats_bwd_plain: every output
    within the bf16 bound 3e-2 of its max-abs."""
    errs = (_head_block_case(c, heads, cl, shift=4) if rows == "whole" else
            _head_block_case(c, heads, cl, edges=(False, False)))
    for i, (err, mx) in enumerate(errs):
        assert mx > 0 and err <= 3e-2 * mx, f"output {i}: {err:.3e} > 3e-2 * {mx:.3e}"


@pytest.mark.parametrize("c,heads,cl", [(64, 1, 32), (96, 1, 48)])
def test_stats_bwd_head_block_emulation_sees_planted_fault(c, heads, cl):
    """The head-block check is not blind: the k rows of the member's q|k
    weights read at offset C instead of CL moves dx and d wqkv past the bf16
    bound."""
    errs = _head_block_case(c, heads, cl, shift=4, fault="k_at_c")
    assert all(errs[i][0] > 3e-2 * errs[i][1] for i in (0, 1)), errs


def test_stats_bwd_emulation_matches_pallas_interpret():
    """One tiny case (C 16, 2 heads, LN, 2 images of 8x16) of both emulated
    tiles in float32 against the JAX package's _sp0_bwd_call in interpret
    mode with zero halos and both edges true, as the port's kernels take
    them (the slab rows folded into dx by _halo_grads): 1e-4 of each
    output's max-abs."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops.pallas_vjp import _halo_grads, _sp0_bwd_call

    c, heads = 16, 2
    x, wqkv, wdw, nh, lnw, lnb, dg, dq, dk = _inputs(c, heads, torch.float32, 5, True)
    got = _emulate(x, wqkv, wdw, nh, 0, lnw, lnb, 1e-5, dg, dq, dk)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    b, h, w, _ = x.shape
    zero = jnp.zeros((b, 1, w, c), jnp.float32)
    out = _sp0_bwd_call(j(x), zero, zero, jnp.array([1, 1], jnp.int32),
                        j(wqkv.reshape(3 * c, c).t()), j(wdw.reshape(3 * c, 9).t()), j(lnw),
                        j(lnb), j(dg), j(dq), j(dk), num_heads=nh, eps=1e-5, interpret=True)
    dx, dtop, dbot, dwqk, dwdwqk, dlnw, dlnb = out
    dx = _halo_grads(dx, dtop, dbot)[0]
    want = (np.asarray(dx), np.asarray(dwqk).T, np.asarray(dwdwqk).T, np.asarray(dlnw)[0],
            np.asarray(dlnb)[0])
    mine = (got[0], got[1].reshape(3 * c, c)[:2 * c], got[2].reshape(3 * c, 9)[:2 * c], got[3],
            got[4])
    for i, (g, wv) in enumerate(zip(mine, want)):
        err, mx = float(np.abs(g - wv.reshape(g.shape)).max()), float(np.abs(wv).max())
        assert mx > 0 and err <= 1e-4 * mx, f"output {i}: {err:.3e} > 1e-4 * {mx:.3e}"


def test_stats_wrapper_backward_runs_plain_on_cpu():
    """On a CPU tensor the wrapper's backward is the plain one, bf16 included:
    the gradients autograd gives equal spectral_stats_bwd_plain's."""
    x, wqkv, wdw, nh, lnw, lnb, dg, dq, dk = _inputs(36, 2, torch.bfloat16, 3, True)
    ts = [t.clone().requires_grad_(True) for t in (x, wqkv, wdw, lnw, lnb)]
    out = spectral_stats(ts[0], ts[1], ts[2], nh, shift=4, ln_w=ts[3], ln_b=ts[4])
    got = torch.autograd.grad(out, ts, (dg, dq, dk))
    ref = spectral_stats_bwd_plain(x, wqkv, wdw, nh, 4, lnw, lnb, 1e-5, dg, dq, dk)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), i
