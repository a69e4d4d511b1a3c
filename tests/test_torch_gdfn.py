"""The bf16 GDFN tile (``gdfn_tc_kernel`` in csrc/gdfn.cu, K5) without a
card: its operands (``pack_gdfn``) read with the kernel's own indexing (the
plan ``gdfn_plan`` and the weight stream's tile map), and the tile emulated
in numpy on a 16x24 image against ``gdfn_plain``. The kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py. Imports no JAX."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels.gdfn import (
    GDFN_BUDGET, GDFN_K, GDFN_N, GDFN_ROWS, gdfn, gdfn_plain, gdfn_plan, pack_gdfn,
)
from torch_port_inputs import rng as _rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, hid, Co): the presets' calls (flagship fusion1 / fusion2, remote
# sensing fusion1 / fusion2; hid 340 and 510 pad w_out's rows to 344 and 512,
# 1021 to 1024; the last hidden chunk is ragged at every width) and C = 36
# and 27 (rows not 16-byte multiples: w_in's rows padded to 40 and 32; 27 is
# odd, its halo one 32-wide depth step)
WIDTHS = [(128, 340, 64), (256, 680, 128), (192, 510, 96), (384, 1021, 192), (36, 95, 18),
          (27, 71, 13)]


def _dyadic(r, shape, scale, p):
    """Values k * scale, k in {-2..2}, nonzero with probability p: exact in
    bf16, so the packed operands compare exactly."""
    k = r.integers(-2, 3, shape) * (r.random(shape) < p)
    return torch.from_numpy((k * scale).astype(np.float32))


def _stage(flat, base, lds, rows, cols, rmax, cmax):
    """stage_tile (csrc/spectral_front.cuh) in numpy: element (r, c) of the
    rows x cols tile is flat[base + r * lds + c] where r < rmax and c < cmax,
    else zero."""
    r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
    ok = (r < rmax) & (c < cmax)
    return np.where(ok, flat[np.where(ok, base + r * lds + c, 0)], 0).astype(np.float32)


def _stream(pl, c, hid, co, wi, wo, wp):
    """The weight stream's tiles in order, as the kernel's stage function
    copies them: per hidden chunk nk project_in tiles ([128][64]: the
    chunk's x1 rows, then its x2 rows of w_in) and nk2 project_out tiles
    (128 output channels of w_out at the chunk's 64 hidden units), then the
    exit 1x1's npb x nk tiles."""
    c8, hid8, ck = wi.shape[1], wo.shape[1], -(-c // 64) * 64
    fi, fo = wi.float().numpy().ravel(), wo.float().numpy().ravel()
    per, tiles = pl["nk"] + pl["nk2"], []
    for t in range(pl["tiles"]):
        if t < pl["nch"] * per:
            j0, pos = t // per * GDFN_K, t % per
            if pos < pl["nk"]:
                k0 = GDFN_K * pos
                tiles.append(np.concatenate([
                    _stage(fi, j0 * c8 + k0, c8, GDFN_K, GDFN_K, hid - j0, c8 - k0),
                    _stage(fi, (hid + j0) * c8 + k0, c8, GDFN_K, GDFN_K, hid - j0, c8 - k0)]))
            else:
                n0 = GDFN_N * (pos - pl["nk"])
                tile = np.zeros((GDFN_N, GDFN_K), np.float32)
                rows = min(GDFN_N, ck - n0)
                tile[:rows] = _stage(fo, n0 * hid8 + j0, hid8, rows, GDFN_K, c - n0, hid8 - j0)
                tiles.append(tile)
        else:
            u = t - pl["nch"] * per
            n0, k0 = u // pl["nk"] * GDFN_N, u % pl["nk"] * GDFN_K
            tiles.append(_stage(wp.float().numpy().ravel(), n0 * c8 + k0, c8, GDFN_N, GDFN_K,
                                co - n0, c8 - k0))
    return tiles


def _chunk_taps(taps, j0, hid):
    """The chunk's taps as the kernel stages them: [9][128] float32, column u
    < 64 x1 unit j0 + u, the rest x2 unit j0 + u - 64, zero past hid."""
    flat = taps.float().numpy().ravel()
    tp = np.zeros((9, 2 * GDFN_K), np.float32)
    for u in range(2 * GDFN_K):
        unit = j0 + u % GDFN_K
        if unit < hid:
            row = unit if u < GDFN_K else hid + unit
            tp[:, u] = flat[row * 9:row * 9 + 9]
    return tp


def _rnd(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt).float().numpy()


def _emulate(x, ln_w, ln_b, pl, tiles, taps, c, hid, co, residual, proj, dt):
    """The tile on every 8x8 tile of x (1, H, W, C): the halo (LN rounded to
    dt, zero outside the image), per hidden chunk project_in from its tiles in
    float32, the depthwise 3x3 in float32, gelu(x1) * x2 rounded to dt,
    project_out summed over the chunks; + x, rounded; the exit 1x1 from its
    tiles, rounded."""
    _, h, w, _ = x.shape
    xn = layer_norm(x, ln_w, ln_b).float().numpy()[0]
    xf = x.float().numpy()[0]
    cp, nk, nk2, per = pl["cp"], pl["nk"], pl["nk2"], pl["nk"] + pl["nk2"]
    ck = -(-c // 64) * 64
    out = np.zeros((h, w, co if proj else c), np.float32)
    for ty in range(h // 8):
        for tx in range(w // 8):
            halo = np.zeros((GDFN_ROWS, cp), np.float32)
            for p in range(100):
                r, q = ty * 8 + p // 10 - 1, tx * 8 + p % 10 - 1
                if 0 <= r < h and 0 <= q < w:
                    halo[p, :c] = xn[r, q]
            acc = np.zeros((64, ck), np.float32)
            for jc in range(pl["nch"]):
                win = np.concatenate(tiles[jc * per:jc * per + nk], axis=1)[:, :cp]
                t = halo @ win.T
                assert not t[100:].any()
                t = t[:100].reshape(10, 10, 2 * GDFN_K)
                tp = _chunk_taps(taps, jc * GDFN_K, hid)
                a = np.zeros((8, 8, 2 * GDFN_K), np.float32)
                for tap in range(9):
                    a += t[tap // 3:tap // 3 + 8, tap % 3:tap % 3 + 8] * tp[tap]
                a = a.reshape(64, 2 * GDFN_K)
                g = (gelu_exact(torch.from_numpy(a[:, :GDFN_K])) * torch.from_numpy(a[:, GDFN_K:]))
                g = _rnd(g.numpy(), dt)
                for i in range(nk2):
                    n0 = GDFN_N * i
                    rows = min(GDFN_N, ck - n0)
                    acc[:, n0:n0 + rows] += g @ tiles[jc * per + nk + i][:rows].T
            y = acc[:, :c] + (xf[ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8].reshape(64, c)
                              if residual else 0)
            y = _rnd(y, dt)
            if proj:
                yp = np.zeros((64, cp), np.float32)
                yp[:, :c] = y
                o = np.zeros((64, pl["npb"] * GDFN_N), np.float32)
                base = pl["nch"] * per
                for nb in range(pl["npb"]):
                    wt = np.concatenate(tiles[base + nb * nk:base + (nb + 1) * nk], axis=1)
                    o[:, nb * GDFN_N:(nb + 1) * GDFN_N] = yp @ wt[:, :cp].T
                y = _rnd(o[:, :co], dt)
            out[ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8] = y.reshape(8, 8, -1)
    return out


@pytest.mark.parametrize("c,hid,co", WIDTHS)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_gdfn_pack_layout(c, hid, co, dt):
    """pack_gdfn's operands and gdfn_plan's tiling read with the kernel's
    indexing: the weight stream's tiles give back the x1 and x2 rows of w_in
    per hidden chunk, w_out's columns and proj_w exactly, with zeros past
    hid, C and Co; the staged taps are w_dw's rows; views where no cast or
    padding is needed; the plan within its budget."""
    r = _rng(16 + c)
    w_in = _dyadic(r, (2 * hid, c, 1, 1), 1 / 8, 0.25)
    w_dw = _dyadic(r, (2 * hid, 1, 3, 3), 1 / 2, 0.5)
    w_out = _dyadic(r, (c, hid, 1, 1), 1 / 8, 0.25)
    proj = _dyadic(r, (co, c, 1, 1), 1 / 8, 0.5)
    wi, taps, wo, wp = pack_gdfn(w_in, w_dw, w_out, proj, dt)
    c8, hid8 = -(-c // 8) * 8, -(-hid // 8) * 8
    assert (wi.shape, taps.shape, wo.shape, wp.shape) == ((2 * hid, c8), (2 * hid, 9), (c, hid8),
                                                          (co, c8))
    assert all(t.dtype == dt and t.is_contiguous() for t in (wi, taps, wo, wp))
    if dt == torch.float32:  # no cast: views wherever no row is padded
        assert (wi.data_ptr() == w_in.data_ptr()) == (c % 8 == 0)
        assert (wo.data_ptr() == w_out.data_ptr()) == (hid % 8 == 0)
        assert taps.data_ptr() == w_dw.data_ptr()
    pl = gdfn_plan(c, hid, co)
    assert pl["bytes"] <= GDFN_BUDGET and pl["ws"] >= 2 and pl["nk"] * GDFN_K >= pl["cp"]
    assert pl["nch"] * GDFN_K >= hid > (pl["nch"] - 1) * GDFN_K
    assert gdfn_plan(c, hid, 0)["bytes"] == pl["bytes"]  # the exit adds tiles, not bytes
    tiles = _stream(pl, c, hid, co, wi, wo, wp)
    assert len(tiles) == pl["tiles"] and all(t.shape == (GDFN_N, GDFN_K) for t in tiles)
    per, nk = pl["nk"] + pl["nk2"], pl["nk"]
    want_in = np.zeros((2 * pl["nch"] * GDFN_K, nk * GDFN_K), np.float32)
    wf = w_in.reshape(2 * hid, c).numpy()
    want_in[:hid, :c], want_in[pl["nch"] * GDFN_K:pl["nch"] * GDFN_K + hid, :c] = wf[:hid], wf[hid:]
    for jc in range(pl["nch"]):
        got = np.concatenate(tiles[jc * per:jc * per + nk], axis=1)
        rows = np.r_[jc * GDFN_K:(jc + 1) * GDFN_K,
                     pl["nch"] * GDFN_K + jc * GDFN_K:pl["nch"] * GDFN_K + (jc + 1) * GDFN_K]
        np.testing.assert_array_equal(got, want_in[rows])
        out = np.concatenate(tiles[jc * per + nk:(jc + 1) * per])[:c]
        want = np.zeros((c, GDFN_K), np.float32)
        cols = w_out.reshape(c, hid).numpy()[:, jc * GDFN_K:(jc + 1) * GDFN_K]
        want[:, :cols.shape[1]] = cols
        np.testing.assert_array_equal(out, want)
        assert not np.concatenate(tiles[jc * per + nk:(jc + 1) * per])[c:].any()
        tp = _chunk_taps(taps, jc * GDFN_K, hid)
        wd = w_dw.reshape(2 * hid, 9).numpy()
        n = min(GDFN_K, hid - jc * GDFN_K)
        np.testing.assert_array_equal(tp[:, :n], wd[jc * GDFN_K:jc * GDFN_K + n].T)
        np.testing.assert_array_equal(tp[:, GDFN_K:GDFN_K + n],
                                      wd[hid + jc * GDFN_K:hid + jc * GDFN_K + n].T)
        assert not tp[:, n:GDFN_K].any() and not tp[:, GDFN_K + n:].any()
    exit_ = np.concatenate([np.concatenate(tiles[pl["nch"] * per + b * nk:
                                                 pl["nch"] * per + (b + 1) * nk], axis=1)
                            for b in range(pl["npb"])])
    want = np.zeros_like(exit_)
    want[:co, :c] = proj.reshape(co, c).numpy()
    np.testing.assert_array_equal(exit_, want)


@pytest.mark.parametrize("c,hid,co", WIDTHS)
@pytest.mark.parametrize("residual,proj", [(False, False), (True, False), (True, True),
                                           (False, True)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_gdfn_tile_emulation_matches_plain(c, hid, co, residual, proj, dt):
    """The tile emulated in numpy from the packed operands and the weight
    stream's tiles on a 16x24 image (6 tiles, the halo's edges and corners)
    against gdfn_plain on the same inputs. float32: the same arithmetic in
    other orders, 1e-5 of the output's max-abs. bf16: the same rounding
    points, where a float32 sum in another order can flip one rounding of the
    gated product, y or the exit's output: 1e-2 of the max-abs (an indexing
    fault moves outputs by their whole scale)."""
    r = _rng(30 + c)
    x = torch.from_numpy(r.standard_normal((1, 16, 24, c)).astype(np.float32)).to(dt)
    ln_w = torch.from_numpy(1 + 0.1 * r.standard_normal(c).astype(np.float32))
    ln_b = torch.from_numpy(0.5 * r.standard_normal(c).astype(np.float32))
    w_in = _dyadic(r, (2 * hid, c, 1, 1), 1 / 8, 0.25)
    w_dw = _dyadic(r, (2 * hid, 1, 3, 3), 1 / 2, 0.5)
    w_out = _dyadic(r, (c, hid, 1, 1), 1 / 8, 0.25)
    pw = _dyadic(r, (co, c, 1, 1), 1 / 8, 0.5) if proj else None
    wi, taps, wo, wp = pack_gdfn(w_in, w_dw, w_out, pw, dt)
    pl = gdfn_plan(c, hid, co if proj else 0)
    got = _emulate(x, ln_w, ln_b, pl, _stream(pl, c, hid, co, wi, wo, wp), taps, c, hid, co,
                   residual, proj, dt)
    ref = gdfn_plain(x, ln_w, ln_b, w_in, w_dw, w_out, residual=residual, proj_w=pw)
    ref = ref.float().numpy()[0]
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    tol = 1e-2 if dt == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_gdfn_wrapper_runs_plain_on_cpu():
    """On a CPU tensor the wrapper is its plain version, bf16 included."""
    r = _rng(5)
    c, hid = 36, 95
    x = torch.from_numpy(r.standard_normal((1, 8, 16, c)).astype(np.float32)).to(torch.bfloat16)
    w = [torch.from_numpy(r.standard_normal(s).astype(np.float32) * 0.1)
         for s in ((c,), (c,), (2 * hid, c, 1, 1), (2 * hid, 1, 3, 3), (c, hid, 1, 1))]
    assert torch.equal(gdfn(x, *w, residual=True), gdfn_plain(x, *w, residual=True))
