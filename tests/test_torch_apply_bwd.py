"""The bf16 spectral apply backward (K10b) without a card: the plan mirror
``apply_bwd_tc_plan``, and both of its tiles emulated in numpy from their
own tile maps (launch 1, ``spectral_apply_bwd_tc_kernel``: v recomputed in
the forward front's passes, dys and the extra cotangent, comb streamed as
64-row tiles each read plain for its dv slab and transposed for the
drop-path product br, the per-tile d dp partial; launch 2,
``dwconv_dx_tc_kernel<true, true>`` at K = C with the extra added before dx
rounds, tests/dwconv_dx_emulation.py) and the wrapper's d gate, weight
products and the in-order sums (per image, then over the images), at the
rounding points of
``spectral_apply_bwd_plain``, against it, on the whole attention and on a
member's head block (v width CL < C, comb (B, CL, C)). The kernels themselves are held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py. Imports no JAX."""

import numpy as np
import pytest
import torch

from dwconv_dx_emulation import (
    halo_row_out, halo_rows_bwd, halo_taps, interior, launch2, ln, rnd, tile_rows, tiles, untile,
)
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    DX_LDD, DX_LDT, FRONT_K, STATS_BUDGET, Halo, apply_bwd_tc_plan, front_plan, pack_front,
    spectral_apply, spectral_apply_bwd_plain,
)
from torch_port_inputs import normal as _n, rng as _rng, uniform as _u
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# the presets' apply widths (flagship 64, 128, 256; remote sensing 96, 192,
# 384) and C = 36 and 27 (rows not 16-byte multiples; 27 odd)
WIDTHS = [64, 128, 256, 96, 192, 384, 36, 27]
# tile 1's plan: (front bytes, comb stages, bytes) and tile 2's (ring stages,
# bytes) at K = C
PLANS = {64: (54144, 3, 46080, 3, 161664), 128: (105472, 3, 87040, 3, 186240),
         256: (134400, 3, 168960, 2, 160000), 96: (79808, 3, 66560, 3, 186240),
         192: (156800, 3, 128000, 3, 210816), 384: (200192, 2, 200704, 2, 192768),
         36: (54144, 3, 46080, 3, 161664), 27: (28480, 3, 25600, 3, 161664)}
# the call shapes of the train steps: the PGSSTB call (gate, shortcut,
# drop-path, shift 0 and 4; the blocks at rate 0 without drop-path; a
# shifted block's per-pixel gate map on a row shard) and the
# TransformerBlock call (LN, residual)
VARIANTS = {"gate_dp0": dict(gate=True, dp=True, shift=0),
            "gate_dp4": dict(gate=True, dp=True, shift=4),
            "gate0": dict(gate=True, dp=False, shift=0),
            "gmap_dp0": dict(gate="map", dp=True, shift=0),
            "ln_res0": dict(ln=True, residual=True, shift=0)}


def _gmap(gate, shift, h):
    """The gates of the rolled frame (per-window, or a per-pixel map) as a
    per-pixel map of the unrolled frame (each tile pixel's egate row,
    gate_row)."""
    g = gate if gate.shape[1] == h else np.repeat(np.repeat(gate, 8, axis=1), 8, axis=2)
    return np.roll(g, (shift, shift), axis=(1, 2))


def _launch1(x, wv, wd, cb, gate, dp, residual, dy, lnw, lnb, shift, dt, eps, flipped=True,
             hrows=(None, None)):
    """The first tile on every 8x8 tile: (un, t, v, dys, dv, extra, the d dp
    partial per tile) in the unrolled frame, then un_halo ([2][B][W][C]) and
    t_halo ([2][B][W][CL]): the LN'd input and v 1x1 output of a row
    shard's staged halo rows ``hrows`` (test_torch_stats_bwd's _halo_in),
    which the first and last tile rows write (zero on a side without a
    row). CL = wv's rows: C, or a member's head block (comb (B, CL, C)).
    flipped=False reads comb unflipped in the dv product (dys comb in place
    of dys comb^T, a planted fault at CL = C)."""
    b, h, w, c = x.shape
    cl = wv.shape[0]
    pl = apply_bwd_tc_plan(c, cl)
    cpl, npass = pl["cpl"], pl["np"]
    raw = np.roll(x, (shift, shift), axis=(1, 2))
    un = raw if lnw is None else rnd(ln(raw, lnw, lnb, eps)[2], dt)
    halo = tiles(un, *hrows)  # the halo staged as bf16, LN in place, zero outside
    sides = [s for s in range(2) if hrows[s] is not None]
    un_h, t_h = np.zeros((2, b, w, c), np.float32), np.zeros((2, b, w, cl), np.float32)
    for side in sides:
        un_h[side] = halo_row_out(halo, side, b, h, w)
    t_out = np.zeros(halo.shape[:3] + (64, cl), np.float32)
    v = np.zeros(halo.shape[:3] + (64, cpl), np.float32)
    for n0 in range(0, cpl, npass):  # the passes of the v rows
        cols = np.arange(n0, min(n0 + npass, cl))
        if not len(cols):
            continue
        t = rnd(halo @ wv[cols, :c].T, dt)  # [..., 100, np]
        t_out[..., cols] = interior(t)
        for side in sides:
            t_h[side][..., cols] = halo_row_out(t, side, b, h, w)
        t10 = t.reshape(*t.shape[:-2], 10, 10, len(cols))
        acc = np.zeros(t.shape[:-2] + (8, 8, len(cols)), np.float32)
        for tap in range(9):
            dy_, dx_ = divmod(tap, 3)
            acc += t10[..., dy_:dy_ + 8, dx_:dx_ + 8, :] * wd[cols, tap]
        v[..., cols] = rnd(acc.reshape(*acc.shape[:-3], 64, len(cols)), dt)
    d0 = tile_rows(dy)
    ds = d0 if dp is None else rnd(d0 * dp[:, None, None, None, None], dt)
    extra = None
    g = None if gate is None else tile_rows(_gmap(gate, shift, x.shape[1]))
    if gate is not None or residual:
        extra = (ds * g if gate is not None else 0) + (d0 if residual else 0)
    dv = np.zeros(ds.shape[:-1] + (cl,), np.float32)
    br = np.zeros_like(ds)
    cbt = cb[:, None, None]  # [B][1][1][CL][C]: each image's comb
    for k0 in range(0, cpl, FRONT_K):  # the comb tiles: 64 rows (v channels)
        rows = np.arange(k0, min(k0 + FRONT_K, cl))
        if not len(rows):
            continue
        tile = cbt[..., rows, :]  # [64 k][C o]
        dv[..., rows] = ds @ (np.swapaxes(tile, -1, -2) if flipped else cbt[..., :, rows])
        br += v[..., rows] @ tile
    part = None
    if dp is not None:
        ug = 0 if gate is None else tile_rows(raw) * g
        part = (d0 * (br + ug)).sum((-2, -1))  # [B][ty][tx]
    unt = lambda a: untile(a.reshape(-1, 64, a.shape[-1]), b, h, w)  # noqa: E731
    return (un, unt(t_out), unt(v[..., :cl]), unt(ds), unt(dv),
            None if extra is None else unt(extra), part, un_h, t_h)


def _emulate(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps, dy,
             flipped=True, halo=None, fault=""):
    """Both tiles, d gate, the weight products and the in-order partial sums:
    the outputs of spectral_apply_bwd_plain as numpy arrays. ``halo``: a row
    shard's :class:`Halo` (shift 0); then also grad.cu's halo-row kernel and
    the wrapper's halo-row backward, and the outputs end with d top, d bot.
    Planted faults on a shard: "swapped" (the halo rows top for bottom),
    "edge" (the top edge flag inverted), "no_taps" (the halo rows' tap
    partials left out); on a head block (CL = wqkv.shape[0] / 3 < C):
    "v_at_q" (the v rows of the 1x1 read at the q rows' offset), "dcomb_t"
    (d comb written transposed: [C][CL] in the (CL, C) buffer)."""
    from test_torch_stats_bwd import _halo_in

    dt = x.dtype
    b, h, w, c = x.shape
    cl = wqkv.shape[0] // 3
    wsrc = torch.cat([wqkv[:cl]] * 3) if fault == "v_at_q" else wqkv
    wv, wd, cb = (a.float().numpy() for a in pack_front(wsrc, wdw, comb, dt))
    f = lambda a: None if a is None else a.float().numpy()  # noqa: E731
    xf, lnw, lnb, g, dp = f(x), f(ln_w), f(ln_b), f(gate), f(dp_scale)
    if g is not None:
        g = rnd(g, dt)
    flags, rows, hrows = 0, None, (None, None)
    if halo is not None:
        rows = np.stack([halo.top[:, 0].float().numpy(), halo.bot[:, 0].float().numpy()])
        if fault == "swapped":
            rows = rows[::-1].copy()
        flags = halo.flags ^ (1 if fault == "edge" else 0)
        hrows = _halo_in(rows, flags, lnw, lnb, dt, eps)
    un, t, v, dys, dv, extra, pdp, un_h, t_h = _launch1(
        xf, wv, wd, cb[..., :c], g, dp, residual, dy.float().numpy(), lnw, lnb, shift, dt, eps,
        flipped, hrows)
    dtt, dx, part = launch2(xf, dv, t, wd, wv, lnw, shift, dt, eps, extra)
    if dp is not None:  # tile 1's d dp column
        part = np.concatenate([part, pdp.reshape(-1, 1)], -1)
    per_image = np.zeros((b, part.shape[1]), np.float32)
    for i, row in enumerate(part.reshape(b, -1, part.shape[1])):
        for r in row:  # sum_parts: each image's tiles in order
            per_image[i] += r
    tot = np.zeros(part.shape[1], np.float32)
    for row in per_image:  # then the images in order
        tot += row
    dgate = None
    if g is not None:  # per window of the rolled frame (or per pixel): sum of dys x
        prod = np.roll(dys, (-shift, -shift), axis=(1, 2)) * xf
        if g.shape[1] < h:
            prod = prod.reshape(b, h // 8, 8, w // 8, 8, c).sum((2, 4))
        dgate = rnd(prod, gate.dtype)
    dw = np.zeros((3 * cl, c), np.float32)
    dw[2 * cl:] = dtt.reshape(-1, cl).T @ un.reshape(-1, c)
    dcomb = np.einsum("bpk,bpo->bko", v.reshape(b, -1, cl), dys.reshape(b, -1, c))
    if fault == "dcomb_t":
        dcomb = np.ascontiguousarray(dcomb.transpose(0, 2, 1)).reshape(b, cl, c)
    taps = tot[:9 * cl].reshape(9, cl).copy()
    o = 9 * cl + (2 * c if lnw is not None else 0)
    dln = (tot[9 * cl:9 * cl + c], tot[9 * cl + c:9 * cl + 2 * c]) if lnw is not None else (None, None)
    dtop = dbot = None
    if halo is not None:
        dth, dwh = halo_taps(dv, t_h, wd, flags, dt, fault)
        taps[:3] += dwh[0]
        taps[6:] += dwh[1]
        dtop, dbot, dw_h, dln_h = halo_rows_bwd(dth, wv, rows, lnw, eps, flags, un_h, dt)
        dw[2 * cl:] += dw_h
        if dln_h is not None:
            dln = tuple(a + e for a, e in zip(dln, dln_h))
    dwdw = np.zeros((3 * cl, 9), np.float32)
    dwdw[2 * cl:] = taps.T
    out = (dx, dcomb, dw.reshape(3 * cl, c, 1, 1), dwdw.reshape(3 * cl, 1, 3, 3), *dln, dgate,
           dy.float().numpy(), None if dp is None else per_image[:, o])
    return out if halo is None else out + (dtop, dbot)


def _inputs(c, dt, seed, gate=False, dp=False, ln=False, residual=False, shift=0, b=2, h=8,
            w=16, cl=None):
    """One call's operands; ``cl``: a member's head block (wqkv (3CL, C),
    comb (B, CL, C)) instead of the whole attention."""
    r = _rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(_n(r, s, scale))  # noqa: E731
    cl = c if cl is None else cl
    x = f(b, h, w, c).to(dt)
    comb = f(b, cl, c, scale=cl ** -0.5)
    wqkv, wdw = torch.from_numpy(_u(r, (3 * cl, c, 1, 1), c)), torch.from_numpy(
        _u(r, (3 * cl, 1, 3, 3), 9))
    lnw, lnb = (1 + f(c, scale=0.1), f(c, scale=0.1)) if ln else (None, None)
    gh, gw = (h, w) if gate == "map" else (h // 8, w // 8)
    g = f(b, gh, gw, c, scale=0.5).to(dt) if gate else None
    dps = torch.tensor([1.25, 0.0][:b]) if dp else None
    return (x, comb, wqkv, wdw, shift, lnw, lnb, residual, g, dps, 1e-5, f(b, h, w, c).to(dt))


def _errs(got, ref):
    out = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None, i
            continue
        r = r.float().numpy()
        assert g.shape == r.shape, (i, g.shape, r.shape)
        out.append((i, float(np.abs(g - r).max()), float(np.abs(r).max())))
    return out


def _case(c, variant, dt, flipped=True):
    args = _inputs(c, dt, 80 + c, **VARIANTS[variant])
    return _errs(_emulate(*args, flipped=flipped), spectral_apply_bwd_plain(*args))


@pytest.mark.parametrize("c", WIDTHS)
def test_apply_bwd_tc_plan(c):
    """The plan mirror: tile 1 keeps the forward front's tiling and bytes
    during its front (v | taps | halo | ring), then v | dys | 3 comb stages
    where they fit (2 at C = 384, where 3 would pass the budget); tile 2
    at K = C takes 3 ring stages where they fit and holds its epilogue, the
    extra cotangent's rows included, in them; both within the budget."""
    pl = apply_bwd_tc_plan(c)
    front, cs, post, stages, two = PLANS[c]
    assert (pl["front"], pl["cs"], pl["post"]) == (front, cs, post)
    assert pl["bytes"] == max(front, post) <= STATS_BUDGET
    assert {k: pl[k] for k in front_plan(c)} == front_plan(c)
    v = 2 * 64 * pl["ld"]
    assert pl["ld"] == pl["cp"] + 8 and post == (2 + cs) * v
    if cs == 2:
        assert post + v > STATS_BUDGET
    dx = pl["dx"]
    assert (dx["stages"], dx["bytes"]) == (stages, two) and two <= STATS_BUDGET
    # tile 2's epilogue in its ring: x, LN mean | rstd, row and column sums,
    # the extra cotangent's float32 rows
    ck = dx["ck"]
    epi = 2 * 64 * (ck + 8) + 4 * (2 * 64 + 4 * 64 * 2 + 4 * 2 * ck + 64 * (ck + 4))
    assert epi <= dx["stages"] * dx["stage"]
    assert dx["nck"] * 64 >= c > (dx["nck"] - 1) * 64
    assert dx["stage"] == 4 * 100 * DX_LDD + 2 * 100 * DX_LDT + 2 * 64 * (dx["ck"] + 8)


@pytest.mark.parametrize("c", [64, 27])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_apply_bwd_tiles_emulation_matches_plain(c, variant, dt):
    """Both tiles emulated from their tile maps on 2 images of 8x16 (4 tiles,
    the roll-back wrapping at shift 4; the drop-path scales 1.25 and 0)
    against spectral_apply_bwd_plain, every output. float32: the same
    arithmetic in other orders, 1e-4 of each output's max-abs. bf16: the same
    rounding points (t, v, comb, dys, dtt, dx), where a float32 sum in
    another order can flip one rounding: 3e-2."""
    tol = 3e-2 if dt == torch.bfloat16 else 1e-4
    for i, err, mx in _case(c, variant, dt):
        assert mx > 0 and err <= tol * mx, f"output {i}: {err:.3e} > {tol} * {mx:.3e}"


EDGES = [(True, True), (True, False), (False, True), (False, False)]


def _halo_case(c, variant, edges, fault=""):
    """A row shard of one tile row (2 images of 8 x 16, shift 0) with its
    bf16 halo rows: (emulation errors against spectral_apply_bwd_plain,
    every output both have; whether both give the halo cotangents at the
    same sides)."""
    args = list(_inputs(c, torch.bfloat16, 95 + c, **VARIANTS[variant]))
    r = _rng(9)
    top, bot = (torch.from_numpy(_n(r, (2, 1, 16, c))).to(torch.bfloat16) for _ in range(2))
    halo = Halo(top, bot, *edges)
    got = _emulate(*args, halo=halo, fault=fault)
    ref = spectral_apply_bwd_plain(*args, halo=halo)
    same = all((g is None) == (r_ is None) for g, r_ in zip(got[-2:], ref[-2:]))
    keep = [i for i, (g, r_) in enumerate(zip(got, ref)) if g is not None and r_ is not None]
    return _errs([got[i] for i in keep], [ref[i] for i in keep]), same


@pytest.mark.parametrize("c", [64, 27])
@pytest.mark.parametrize("variant", ["gate_dp0", "gmap_dp0", "ln_res0"])
@pytest.mark.parametrize("edges", EDGES, ids=lambda e: f"edge{int(e[0])}{int(e[1])}")
def test_apply_bwd_halo_emulation_matches_plain(c, variant, edges):
    """On a bf16 row shard with its halo rows (the first tile staging them
    through the halo source map, writing their LN'd input and v 1x1 output;
    grad.cu's halo-row kernel adding their cotangents and tap partials; the
    wrapper's halo-row backward through the v rows and the LayerNorm)
    against spectral_apply_bwd_plain with the same Halo, the PGSSTB call
    (gate or a shifted block's gate map, shortcut, drop-path) and the
    PromptFusion call (LN, residual):
    every output, d top and d bottom included, within the bf16 bound 3e-2
    of its max-abs, and the halo cotangents at the same sides."""
    errs, same = _halo_case(c, variant, edges)
    assert same
    for i, err, mx in errs:
        assert err <= 3e-2 * mx, f"output {i}: {err:.3e} > 3e-2 * {mx:.3e}"


@pytest.mark.parametrize("fault", ["swapped", "edge", "no_taps"])
def test_apply_bwd_halo_emulation_sees_planted_faults(fault):
    """The halo check is not blind: the halo rows swapped top for bottom,
    the top edge flag inverted (the image edge's wrapped row taken as real)
    and the halo rows' tap partials left out each move an output past the
    bf16 bound (or put a halo cotangent at the wrong side)."""
    edges = (True, False) if fault == "edge" else (False, False)
    errs, same = _halo_case(64, "ln_res0", edges, fault)
    assert not same or any(err > 3e-2 * mx for _, err, mx in errs), errs


@pytest.mark.parametrize("c", [64, 27])
def test_apply_bwd_emulation_sees_the_flip(c):
    """The check is not blind to comb's orientation in the dv product: comb
    read unflipped (dys comb for dys comb^T) moves dx and d wqkv past the
    bf16 bound."""
    errs = {i: (err, mx) for i, err, mx in _case(c, "gate_dp4", torch.bfloat16, flipped=False)}
    assert all(errs[i][0] > 3e-2 * errs[i][1] for i in (0, 2)), errs


# a member's head block under the spectral mesh axis, bf16: (C, CL) at CL =
# C / 2 and C / 4 of the presets' widths, CL = 48 (the remote-sensing
# preset's C = 96 on two members) and an odd one (C = 36, CL = 18)
HEAD_BLOCKS = [(64, 32), (128, 64), (128, 32), (96, 48), (192, 96), (192, 48), (36, 18)]
# the head block's calls: the PGSSTB's TP route (gate over n, drop-path, no
# LN, no residual), per-window gates at shift 0 or a row shard's gate map
TP_VARIANTS = {"gate_dp0": dict(gate=True, dp=True), "gmap_dp0": dict(gate="map", dp=True)}


def _head_block_case(c, cl, variant, halo=False, fault=""):
    """A member's bf16 head block: the emulation's errors against
    spectral_apply_bwd_plain, every output (with ``halo``: interior halo
    rows of a row shard, d top and d bot too)."""
    args = list(_inputs(c, torch.bfloat16, 85 + c + cl, cl=cl, **TP_VARIANTS[variant]))
    kw = {}
    if halo:
        r = _rng(10 + cl)
        top, bot = (torch.from_numpy(_n(r, (2, 1, 16, c))).to(torch.bfloat16) for _ in range(2))
        kw["halo"] = Halo(top, bot, False, False)
    got = _emulate(*args, fault=fault, **kw)
    ref = spectral_apply_bwd_plain(*args, **kw)
    keep = [i for i, (g, r_) in enumerate(zip(got, ref)) if g is not None and r_ is not None]
    return _errs([got[i] for i in keep], [ref[i] for i in keep])


@pytest.mark.parametrize("c,cl", HEAD_BLOCKS)
@pytest.mark.parametrize("variant", sorted(TP_VARIANTS))
def test_apply_bwd_head_block_emulation_matches_plain(c, cl, variant):
    """Both bf16 tiles on a member's head block (the first with v, t and dv
    CL wide, comb (B, CL, C) streamed in CL / 64 tiles; the second at K =
    CL; d comb (B, CL, C), the weight cotangents (3CL, C)), with interior
    halo rows, against spectral_apply_bwd_plain: every output within the
    bf16 bound 3e-2 of its max-abs."""
    for i, err, mx in _head_block_case(c, cl, variant, halo=True):
        assert mx > 0 and err <= 3e-2 * mx, f"output {i}: {err:.3e} > 3e-2 * {mx:.3e}"


@pytest.mark.parametrize("fault", ["v_at_q", "dcomb_t"])
def test_apply_bwd_head_block_emulation_sees_planted_faults(fault):
    """The head-block check is not blind: the v rows of the 1x1 read at the
    q rows' offset (moving dx and d comb, through v), and d comb written
    transposed (moving d comb), each pass the bf16 bound."""
    errs = {i: (err, mx) for i, err, mx in _head_block_case(96, 48, "gate_dp0", fault=fault)}
    for i in ((0, 1) if fault == "v_at_q" else (1,)):
        assert errs[i][0] > 3e-2 * errs[i][1], (fault, i, errs)


def test_apply_wrapper_backward_runs_plain_on_cpu():
    """On a CPU tensor the wrapper's backward is the plain one, bf16 included:
    the gradients autograd gives equal spectral_apply_bwd_plain's."""
    x, comb, wqkv, wdw, shift, _, _, _, gate, dp, eps, dy = _inputs(
        36, torch.bfloat16, 3, gate=True, dp=True, shift=4)
    short = torch.zeros_like(x)
    ts = [t.clone().requires_grad_(True) for t in (x, comb, wqkv, wdw, gate, short, dp)]
    out = spectral_apply(ts[0], ts[1], ts[2], ts[3], shift=shift, gate=ts[4], shortcut=ts[5],
                         dp_scale=ts[6])
    got = torch.autograd.grad(out, ts, dy)
    ref = spectral_apply_bwd_plain(x, comb, wqkv, wdw, shift, None, None, False, gate, dp, eps, dy)
    for i, (g, r) in enumerate(zip(got, [ref[k] for k in (0, 1, 2, 3, 6, 7, 8)])):
        assert torch.equal(g, r), i
