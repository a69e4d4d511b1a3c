"""The bf16 GDFN backward (K11) without a card: the plan mirror
``gdfn_bwd_tc_plan``, and both of its tiles emulated in numpy from their own
tile maps (launch 1, ``gdfn_bwd_tc_kernel``: the halo with LN, project_in
from the forward tile's weight stream, float32 t, the depthwise 3x3 in tap
order with the taps read from [2 hid][9], gated, dgated from the project_out
tiles read transposed, dc; launch 2, ``dwconv_dx_tc_kernel<true, true,
true>`` at K = 2 hid with float32 t and dy added before dx rounds,
tests/dwconv_dx_emulation.py) and the wrapper's weight products and in-order
sums (per image, then over the images), at the rounding points of
``gdfn_bwd_plain``, against it; one tiny case against JAX's
``_gdfn_bwd_call`` in interpret mode. The kernels themselves are held against
the plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
Imports JAX only in the test that compares with it."""

import numpy as np
import pytest
import torch

from dwconv_dx_emulation import interior, launch2, ln, rnd, tile_rows, tiles, untile
from mp_hsir_tpu_torch.ops.basic import gelu_exact
from mp_hsir_tpu_torch.ops.kernels.gdfn import (
    GDFN_BUDGET, GDFN_K, GDFN_N, gdfn, gdfn_bwd_plain, gdfn_bwd_tc_plan, gdfn_plan, pack_gdfn,
)
from mp_hsir_tpu_torch.ops.kernels.spectral import DX_LDD
from test_torch_gdfn import _stream
from torch_port_inputs import normal as _n, rng as _rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, hid) of the presets' TransformerBlock calls (flagship 128 / 340 and 256
# / 680, remote sensing 192 / 510 and 384 / 1021, where x2's columns start at
# an odd offset and K = 2042 is not a multiple of 4) and C = 36 and 27 (rows
# not 16-byte multiples; 27 odd; hid 95 and 71 odd)
WIDTHS = [(128, 340), (256, 680), (192, 510), (384, 1021), (36, 95), (27, 71)]
# the dynamic bytes of both tiles' plans: tile 1 (ring stages, bytes: t
# 54,400 + halo 112 x (CP + 8) x 2 + dy 64 x (CP + 8) x 2 + the ring) and
# tile 2 (ring stages, bytes: the dt chunk 9,216 + stages of dout and t
# [100][68] float32 and the w rows [64][CK + 8] bf16)
PLANS = {128: (4, 176000, 3, 224640), 256: (4, 221056, 2, 185600), 192: (4, 198528, 2, 169216),
         384: (2, 229248, 2, 218368), 36: (4, 153472, 3, 200064), 27: (4, 142208, 3, 200064)}
TAPS_BYTES = 4 * 9 * 2 * GDFN_K  # the forward tile's staged float32 taps


def _dgelu(a):
    a = torch.from_numpy(a)
    phi = torch.exp(-0.5 * a * a) * (2 * torch.pi) ** -0.5
    return (0.5 * (1 + torch.erf(a * 2 ** -0.5)) + a * phi).numpy()


def _gelu(a):
    return gelu_exact(torch.from_numpy(a)).numpy()


def _launch1(x, lnw, lnb, wi, taps, wo, dy, dt, eps, trans=True):
    """The first tile on every 8x8 tile of x (B, H, W, C): (xn, t, dc,
    gated) as (B, H, W, n) arrays. wi, taps, wo: pack_gdfn's operands.
    trans=False reads each project_out tile plain (each 16 x 16 block
    transposed: ldmatrix without .trans, a planted fault)."""
    b, h, w, c = x.shape
    hid = taps.shape[0] // 2
    k = 2 * hid
    pl = gdfn_bwd_tc_plan(c, hid)
    cp, nk, nk2, per = pl["cp"], pl["nk"], pl["nk2"], pl["nk"] + pl["nk2"]
    stream = _stream(gdfn_plan(c, hid), c, hid, 0, wi, wo, None)
    assert len(stream) == pl["tiles"]
    xn = rnd(ln(x, lnw, lnb, eps)[2], dt)
    halo = np.zeros(x.shape[:1] + (h // 8, w // 8, 100, cp), np.float32)
    halo[..., :c] = tiles(xn)  # the halo staged, LN in place, zero outside the image
    dys = np.zeros(x.shape[:1] + (h // 8, w // 8, 64, cp), np.float32)
    dys[..., :c] = tile_rows(dy)
    tf = taps.float().numpy()
    t_out = np.zeros(halo.shape[:3] + (64, k), np.float32)
    dc = np.zeros_like(t_out)
    gated = np.zeros(halo.shape[:3] + (64, hid), np.float32)
    for jc in range(pl["nch"]):
        j0 = jc * GDFN_K
        units = np.arange(j0, min(j0 + GDFN_K, hid))
        n = len(units)
        win = np.concatenate(stream[jc * per:jc * per + nk], axis=1)[:, :cp]  # [128][cp]
        t = halo @ win.T  # [..., 100, 128]: x1 units j0.., then x2 units j0..
        inner = interior(t)
        t_out[..., units], t_out[..., hid + units] = inner[..., :n], inner[..., GDFN_K:GDFN_K + n]
        wt = np.zeros((9, 2 * GDFN_K), np.float32)  # the taps as the kernel reads them
        wt[:, :n], wt[:, GDFN_K:GDFN_K + n] = tf[units].T, tf[hid + units].T
        t10 = t.reshape(*t.shape[:-2], 10, 10, 2 * GDFN_K)
        a = np.zeros(t.shape[:-2] + (8, 8, 2 * GDFN_K), np.float32)
        for tap in range(9):
            ty, tx = divmod(tap, 3)
            a += t10[..., ty:ty + 8, tx:tx + 8, :] * wt[tap]
        a = a.reshape(*a.shape[:-3], 64, 2 * GDFN_K)
        a1, a2 = a[..., :GDFN_K], a[..., GDFN_K:]
        gated[..., units] = rnd(_gelu(a1) * a2, dt)[..., :n]
        dg = np.zeros(halo.shape[:3] + (64, GDFN_K), np.float32)
        for i in range(nk2):  # dgated: B = the tile as [k = channel][n = unit]
            tile = stream[jc * per + nk + i]
            if not trans:
                tile = tile.reshape(8, 16, 4, 16).transpose(0, 3, 2, 1).reshape(GDFN_N, GDFN_K)
            depth = min(GDFN_N, cp - GDFN_N * i)
            dg += dys[..., GDFN_N * i:GDFN_N * i + depth] @ tile[:depth]
        dc[..., units] = (dg * a2 * _dgelu(a1))[..., :n]
        dc[..., hid + units] = (dg * _gelu(a1))[..., :n]
    unt = lambda a: untile(a.reshape(-1, 64, a.shape[-1]), b, h, w)  # noqa: E731
    return xn, unt(t_out), unt(dc), unt(gated)


def _emulate(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy, trans=True):
    """Both tiles, the weight products and the in-order partial sums: the
    outputs of gdfn_bwd_plain as numpy arrays."""
    dt = x.dtype
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    k = 2 * hid
    wi, taps, wo, _ = pack_gdfn(w_in, w_dw, w_out, None, dt)
    xf, dyf = x.float().numpy(), dy.float().numpy()
    lnw, lnb = ln_w.float().numpy(), ln_b.float().numpy()
    xn, t, dc, gated = _launch1(xf, lnw, lnb, wi, taps, wo, dyf, dt, eps, trans)
    dtt, dx, part = launch2(xf, dc, t, taps.float().numpy(), wi.float().numpy(), lnw, 0, dt, eps,
                            dyf if residual else None)
    per_image = np.zeros((b, part.shape[1]), np.float32)
    for i, rows in enumerate(part.reshape(b, -1, part.shape[1])):
        for r in rows:  # sum_parts: each image's tiles in order
            per_image[i] += r
    tot = np.zeros(part.shape[1], np.float32)
    for row in per_image:  # then the images in order
        tot += row
    dw_in = dtt.reshape(-1, k).T @ xn.reshape(-1, c)
    dw_out = dyf.reshape(-1, c).T @ gated.reshape(-1, hid)
    return (dx, tot[9 * k:9 * k + c], tot[9 * k + c:], dw_in.reshape(k, c, 1, 1),
            tot[:9 * k].reshape(9, k).T.reshape(k, 1, 3, 3), dw_out.reshape(c, hid, 1, 1))


def _inputs(c, hid, dt, seed, residual=True, b=2, h=8, w=16):
    r = _rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(_n(r, s, scale))  # noqa: E731
    return (f(b, h, w, c).to(dt), 1 + f(c, scale=0.1), f(c, scale=0.1),
            f(2 * hid, c, 1, 1, scale=c ** -0.5), f(2 * hid, 1, 3, 3, scale=1 / 3),
            f(c, hid, 1, 1, scale=hid ** -0.5), residual, 1e-5, f(b, h, w, c).to(dt))


def _errs(got, ref):
    out = []
    for i, (g, r) in enumerate(zip(got, ref)):
        r = r.float().numpy()
        assert g.shape == r.shape, (i, g.shape, r.shape)
        out.append((i, float(np.abs(g - r).max()), float(np.abs(r).max())))
    return out


@pytest.mark.parametrize("c,hid", WIDTHS)
def test_gdfn_bwd_tc_plan(c, hid):
    """The plan mirror: tile 1 keeps the forward tile's tiling without the
    exit (t, halo, then dy where the forward kept its taps and gated tile),
    4 ring stages where they fit (2 at C = 384, where the staged taps would
    put 2 stages over the budget); tile 2 with float32 t takes 3 ring
    stages where they fit and holds its epilogue, the extra cotangent's rows
    included, in them; both within the budget."""
    pl = gdfn_bwd_tc_plan(c, hid)
    ws, nbytes, stages, two = PLANS[c]
    assert (pl["ws"], pl["bytes"]) == (ws, nbytes) and nbytes <= GDFN_BUDGET
    fwd = gdfn_plan(c, hid)
    assert all(pl[key] == fwd[key] for key in ("cp", "ld", "nk", "nch", "nk2"))
    assert pl["tiles"] == fwd["tiles"] == fwd["nch"] * (fwd["nk"] + fwd["nk2"])
    assert pl["bytes"] == 4 * 100 * 136 + 2 * (112 + 64) * pl["ld"] + ws * 2 * GDFN_N * 72
    if ws < 4:
        assert pl["bytes"] + 2 * GDFN_N * 72 > GDFN_BUDGET
    if c == 384:  # the choice that made it fit: the taps read from device memory
        assert pl["bytes"] + TAPS_BYTES > GDFN_BUDGET >= pl["bytes"]
    dx = pl["dx"]
    assert (dx["stages"], dx["bytes"]) == (stages, two) and two <= GDFN_BUDGET
    assert dx["stage"] == 2 * 4 * 100 * DX_LDD + 2 * 64 * (dx["ck"] + 8)
    assert dx["nck"] * 64 >= 2 * hid > (dx["nck"] - 1) * 64
    ck = dx["ck"]
    epi = 2 * 64 * (ck + 8) + 4 * (2 * 64 + 4 * 64 * 2 + 4 * 2 * ck + 64 * (ck + 4))
    assert epi <= dx["stages"] * dx["stage"]


@pytest.mark.parametrize("c,hid", [(128, 340), (384, 1021), (36, 95), (27, 71)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_gdfn_bwd_tiles_emulation_matches_plain(c, hid, residual, dt):
    """Both tiles emulated from their tile maps on 2 images of 8x16 (4 tiles)
    against gdfn_bwd_plain, every output. float32: the same arithmetic in
    other orders, 1e-4 of each output's max-abs. bf16: the same rounding
    points (LN(x), gated, dt, dx), where a float32 sum in another order can
    flip one rounding: 3e-2."""
    args = _inputs(c, hid, dt, 60 + c, residual)
    tol = 3e-2 if dt == torch.bfloat16 else 1e-4
    for i, err, mx in _errs(_emulate(*args), gdfn_bwd_plain(*args)):
        assert mx > 0 and err <= tol * mx, f"output {i}: {err:.3e} > {tol} * {mx:.3e}"


@pytest.mark.parametrize("c,hid", [(128, 340), (27, 71)])
def test_gdfn_bwd_emulation_sees_the_transpose(c, hid):
    """The check is not blind to W_out's orientation in dgated: the
    project_out tiles read plain (each 16 x 16 block transposed, ldmatrix
    without .trans) move dx, d w_in and d w_dw past the bf16 bound."""
    args = _inputs(c, hid, torch.bfloat16, 60 + c)
    errs = {i: (err, mx) for i, err, mx in _errs(_emulate(*args, trans=False),
                                                 gdfn_bwd_plain(*args))}
    assert all(errs[i][0] > 3e-2 * errs[i][1] for i in (0, 3, 4)), errs


def test_gdfn_bwd_emulation_matches_pallas_interpret():
    """One tiny case (C 16, hid 24, residual, 1 x 16 x 16) of the emulated
    tiles in float32 against the JAX package's _gdfn_bwd_call run in
    interpret mode: 1e-4 of each output's max-abs (the Pallas GELU is a
    polynomial 1.5e-6 from erf)."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops.pallas_vjp import _gdfn_bwd_call

    c, hid = 16, 24
    x, lw, lb, wi, wd, wo, residual, eps, dy = _inputs(c, hid, torch.float32, 7, b=1, h=16)
    got = _emulate(x, lw, lb, wi, wd, wo, residual, eps, dy)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    want = _gdfn_bwd_call(j(x), j(dy), j(lw), j(lb), j(wi.reshape(2 * hid, c).t().contiguous()),
                          j(wd.reshape(2 * hid, 9).t().contiguous()),
                          j(wo.reshape(c, hid).t().contiguous()), hidden=hid, eps=eps,
                          residual=residual, interpret=True)
    want = [np.asarray(v, np.float32) for v in want]
    want[3], want[4], want[5] = want[3].T, want[4].T, want[5].T  # JAX's (in, out) layouts
    for i, (g, wv) in enumerate(zip(got, want)):
        err, mx = float(np.abs(g - wv.reshape(g.shape)).max()), float(np.abs(wv).max())
        assert err <= 1e-4 * mx, f"output {i}: {err:.3e} > 1e-4 * {mx:.3e}"


def test_gdfn_wrapper_backward_runs_plain_on_cpu():
    """On a CPU tensor the wrapper's backward is the plain one, bf16 included:
    the gradients autograd gives equal gdfn_bwd_plain's."""
    x, lw, lb, wi, wd, wo, residual, eps, dy = _inputs(36, 95, torch.bfloat16, 3)
    ts = [t.clone().requires_grad_(True) for t in (x, lw, lb, wi, wd, wo)]
    got = torch.autograd.grad(gdfn(*ts, residual=residual), ts, dy)
    ref = gdfn_bwd_plain(x, lw, lb, wi, wd, wo, residual, eps, dy)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), i
