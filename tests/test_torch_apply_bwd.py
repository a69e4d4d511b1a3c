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
``spectral_apply_bwd_plain``, against it. The kernels themselves are held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py. Imports no JAX."""

import numpy as np
import pytest
import torch

from dwconv_dx_emulation import interior, launch2, ln, rnd, tile_rows, tiles, untile
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    DX_LDD, DX_LDT, FRONT_K, STATS_BUDGET, apply_bwd_tc_plan, front_plan, pack_front,
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
# drop-path, shift 0 and 4; the blocks at rate 0 without drop-path) and the
# TransformerBlock call (LN, residual)
VARIANTS = {"gate_dp0": dict(gate=True, dp=True, shift=0),
            "gate_dp4": dict(gate=True, dp=True, shift=4),
            "gate0": dict(gate=True, dp=False, shift=0),
            "ln_res0": dict(ln=True, residual=True, shift=0)}


def _gmap(gate, shift):
    """The per-window gates of the rolled frame as a per-pixel map of the
    unrolled frame (each tile pixel's egate row)."""
    g = np.repeat(np.repeat(gate, 8, axis=1), 8, axis=2)
    return np.roll(g, (shift, shift), axis=(1, 2))


def _launch1(x, wv, wd, cb, gate, dp, residual, dy, lnw, lnb, shift, dt, eps, flipped=True):
    """The first tile on every 8x8 tile: (un, t, v, dys, dv, extra, the d dp
    partial per tile) in the unrolled frame. flipped=False reads comb
    unflipped in the dv product (dys comb in place of dys comb^T, a planted
    fault)."""
    b, h, w, c = x.shape
    pl = apply_bwd_tc_plan(c)
    cp, npass = pl["cp"], pl["np"]
    raw = np.roll(x, (shift, shift), axis=(1, 2))
    un = raw if lnw is None else rnd(ln(raw, lnw, lnb, eps)[2], dt)
    halo = tiles(un)  # the halo staged as bf16, LN in place, zero outside
    t_out = np.zeros(halo.shape[:3] + (64, c), np.float32)
    v = np.zeros(halo.shape[:3] + (64, cp), np.float32)
    for n0 in range(0, cp, npass):  # the passes of the v rows
        cols = np.arange(n0, min(n0 + npass, c))
        if not len(cols):
            continue
        t = rnd(halo @ wv[cols, :c].T, dt)  # [..., 100, np]
        t_out[..., cols] = interior(t)
        t10 = t.reshape(*t.shape[:-2], 10, 10, len(cols))
        acc = np.zeros(t.shape[:-2] + (8, 8, len(cols)), np.float32)
        for tap in range(9):
            dy_, dx_ = divmod(tap, 3)
            acc += t10[..., dy_:dy_ + 8, dx_:dx_ + 8, :] * wd[cols, tap]
        v[..., cols] = rnd(acc.reshape(*acc.shape[:-3], 64, len(cols)), dt)
    d0 = tile_rows(dy)
    ds = d0 if dp is None else rnd(d0 * dp[:, None, None, None, None], dt)
    extra = None
    g = None if gate is None else tile_rows(_gmap(gate, shift))
    if gate is not None or residual:
        extra = (ds * g if gate is not None else 0) + (d0 if residual else 0)
    dv = np.zeros_like(ds)
    br = np.zeros_like(ds)
    cbt = cb[:, None, None]  # [B][1][1][C][C]: each image's comb
    for k0 in range(0, cp, FRONT_K):  # the comb tiles: 64 rows (v channels)
        rows = np.arange(k0, min(k0 + FRONT_K, c))
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
    return (un, unt(t_out), unt(v[..., :c]), unt(ds), unt(dv),
            None if extra is None else unt(extra), part)


def _emulate(x, comb, wqkv, wdw, shift, ln_w, ln_b, residual, gate, dp_scale, eps, dy,
             flipped=True):
    """Both tiles, d gate, the weight products and the in-order partial sums:
    the outputs of spectral_apply_bwd_plain as numpy arrays."""
    dt = x.dtype
    b, h, w, c = x.shape
    wv, wd, cb = (a.float().numpy() for a in pack_front(wqkv, wdw, comb, dt))
    f = lambda a: None if a is None else a.float().numpy()  # noqa: E731
    xf, lnw, lnb, g, dp = f(x), f(ln_w), f(ln_b), f(gate), f(dp_scale)
    if g is not None:
        g = rnd(g, dt)
    un, t, v, dys, dv, extra, pdp = _launch1(xf, wv, wd, cb[..., :c], g, dp, residual,
                                             dy.float().numpy(), lnw, lnb, shift, dt, eps,
                                             flipped)
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
    if g is not None:  # per window of the rolled frame: sum of dys x
        prod = np.roll(dys, (-shift, -shift), axis=(1, 2)) * xf
        dgate = rnd(prod.reshape(b, h // 8, 8, w // 8, 8, c).sum((2, 4)), gate.dtype)
    dw = np.zeros((3 * c, c), np.float32)
    dw[2 * c:] = dtt.reshape(-1, c).T @ un.reshape(-1, c)
    dcomb = np.einsum("bpk,bpo->bko", v.reshape(b, -1, c), dys.reshape(b, -1, c))
    dwdw = np.zeros((3 * c, 9), np.float32)
    dwdw[2 * c:] = tot[:9 * c].reshape(9, c).T
    o = 9 * c + (2 * c if lnw is not None else 0)
    dln = (tot[9 * c:10 * c], tot[10 * c:11 * c]) if lnw is not None else (None, None)
    return (dx, dcomb, dw.reshape(3 * c, c, 1, 1), dwdw.reshape(3 * c, 1, 3, 3), *dln, dgate,
            dy.float().numpy(), None if dp is None else per_image[:, o])


def _inputs(c, dt, seed, gate=False, dp=False, ln=False, residual=False, shift=0, b=2, h=8,
            w=16):
    r = _rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(_n(r, s, scale))  # noqa: E731
    x = f(b, h, w, c).to(dt)
    comb = f(b, c, c, scale=c ** -0.5)
    wqkv, wdw = torch.from_numpy(_u(r, (3 * c, c, 1, 1), c)), torch.from_numpy(
        _u(r, (3 * c, 1, 3, 3), 9))
    lnw, lnb = (1 + f(c, scale=0.1), f(c, scale=0.1)) if ln else (None, None)
    g = f(b, h // 8, w // 8, c, scale=0.5).to(dt) if gate else None
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


@pytest.mark.parametrize("c", [64, 27])
def test_apply_bwd_emulation_sees_the_flip(c):
    """The check is not blind to comb's orientation in the dv product: comb
    read unflipped (dys comb for dys comb^T) moves dx and d wqkv past the
    bf16 bound."""
    errs = {i: (err, mx) for i, err, mx in _case(c, "gate_dp4", torch.bfloat16, flipped=False)}
    assert all(errs[i][0] > 3e-2 * errs[i][1] for i in (0, 2)), errs


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
