"""The training data slice of the PyTorch port against the JAX package, on
the CPU at small sizes.

Exact against the JAX code:

* ``data/degradations_np.py`` against JAX's on the same numpy Generator
  (bitwise; the bicubic SR within 1e-6, and the haze whose template is
  resized within 1e-6: OpenCV's float32 INTER_LINEAR, which this copy
  computes in numpy, rounds differently by one float32 ulp);
* ``_kernel_bank``, ``TABLES`` and the type lists of ``ops/pipeline_degrade.py``;
* ``resize_bicubic`` (both ``align_corners``) and ``pixel_replicate_upsample``
  (1e-6), and the haze template resize (``jax.image.resize`` linear,
  antialiased when it downsamples: 1e-6 both ways);
* each deterministic apply of ``ops/degradations.py`` against the JAX
  function, on the draws that the test reproduces from the same
  ``jax.random`` key splits (1e-6; blur 1e-5);
* the 8 augmentation modes against ``_augment_one``, and the batched gather;
* ``utils/image.py``'s crop and band interpolation;
* the patch store's files, written by either package and read by the other.

By distribution (the port's own draws, mirroring
``tests/test_degradations.py``): sigma ranges, a third of the bands struck,
column counts, the impulse rate, the mask rate, the band-miss count and
Poisson.
"""

import os
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mp_hsir_tpu.data import degradations_np as JDN
from mp_hsir_tpu.ops import degradations as JD
from mp_hsir_tpu.ops import pipeline_degrade as JPD
from mp_hsir_tpu.ops import resize as JR
from mp_hsir_tpu.utils import image as JI
from mp_hsir_tpu_torch.data import degradations_np as DN
from mp_hsir_tpu_torch.ops import degradations as D
from mp_hsir_tpu_torch.ops import pipeline_degrade as PD
from mp_hsir_tpu_torch.ops import resize as R
from mp_hsir_tpu_torch.utils import image as I
import torch_threads  # noqa: E402,F401  (one compute thread per process)

CUBE = np.random.default_rng(42).uniform(0.2, 0.8, size=(12, 32, 32)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# degradations_np: the copy against the original, same numpy Generator
# ---------------------------------------------------------------------------

NP_CASES = {
    "gaussian_noise_iid": lambda m, r: m.gaussian_noise_iid(CUBE, r, (30, 70)),
    "gaussian_noise_fixed": lambda m, r: m.gaussian_noise_fixed(CUBE, r, 50),
    "gaussian_noise_non_iid": lambda m, r: m.gaussian_noise_non_iid(CUBE, r, (10, 30, 50, 70)),
    "stripe_noise": lambda m, r: m.stripe_noise(CUBE, r, (0.05, 0.15)),
    "deadline_noise": lambda m, r: m.deadline_noise(CUBE, r),
    "impulse_noise": lambda m, r: m.impulse_noise(CUBE, r, 0.3),
    "poisson_noise": lambda m, r: m.poisson_noise(CUBE, r),
    "gaussian_blur_kernel": lambda m, r: [m.gaussian_blur_kernel(k) for k in (7, 9, 15, 21)],
    "circle_blur_kernel": lambda m, r: [m.circle_blur_kernel(k) for k in (9, 15)],
    "square_blur_kernel": lambda m, r: m.square_blur_kernel(5),
    "motion_blur_kernel": lambda m, r: [m.motion_blur_kernel(k, a) for k, a in
                                        ((15, 45), (9, 30), (21, 10), (7, 90), (15, 137.5))],
    "apply_blur": lambda m, r: m.apply_blur(CUBE, m.gaussian_blur_kernel(9)),
    "pixel_replicate": lambda m, r: m.pixel_replicate(CUBE[:, :8, :8], 4),
    "random_mask": lambda m, r: m.random_mask(CUBE, r, 0.8),
    "band_loss": lambda m, r: m.band_loss(CUBE, r, 0.25),
    "simulate_haze": lambda m, r: m.simulate_haze(CUBE, m.default_cirrus(32, 32, 3), 0.75),
    "default_cirrus": lambda m, r: [m.default_cirrus(h, w, s) for h, w, s in
                                    ((32, 32, 0), (64, 64, 7), (512, 512, 1), (96, 48, 2))],
    "sd_cassi": lambda m, r: m.sd_cassi(CUBE, (r.random((32, 32)) > 0.5).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(NP_CASES))
def test_degradations_np_equal_jax(name):
    want = NP_CASES[name](JDN, np.random.default_rng(5))
    got = NP_CASES[name](DN, np.random.default_rng(5))
    for g, w in zip(*(x if isinstance(x, (list, tuple)) else [x] for x in (got, want))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_degradations_np_sr_equal_jax(factor):
    np.testing.assert_allclose(DN.sr_degrade(CUBE, factor), JDN.sr_degrade(CUBE, factor),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cirrus_hw", [(64, 64), (16, 16), (48, 40)])
def test_degradations_np_haze_resized_template(cirrus_hw):
    cir = JDN.default_cirrus(*cirrus_hw, seed=4)
    np.testing.assert_allclose(DN.simulate_haze(CUBE, cir, 0.5), JDN.simulate_haze(CUBE, cir, 0.5),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# pipeline tables and resizes
# ---------------------------------------------------------------------------

def test_tables_equal_jax():
    assert PD.TABLES == JPD.TABLES
    assert PD.CLASSIFIER_TABLE_OVERRIDES == JPD.CLASSIFIER_TABLE_OVERRIDES
    assert PD.CLASSIFIER_DE_TYPES == JPD.CLASSIFIER_DE_TYPES
    assert (PD.NATURAL_DE_TYPES, PD.REMOTE_DE_TYPES) == (JPD.NATURAL_DE_TYPES, JPD.REMOTE_DE_TYPES)


@pytest.mark.parametrize("ksizes,maker", [((9, 15, 21), "gaussian_blur_kernel"),
                                          ((7, 11, 15), "gaussian_blur_kernel"),
                                          ((9,), "circle_blur_kernel")])
def test_kernel_bank_equal_jax(ksizes, maker):
    np.testing.assert_array_equal(PD._kernel_bank(ksizes, getattr(DN, maker)),
                                  JPD._kernel_bank(ksizes, getattr(JDN, maker)))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("out_hw", [(16, 16), (8, 4), (4, 8), (48, 40)])
def test_resize_bicubic_equal_jax(align, out_hw):
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(JR.resize_bicubic(jnp.asarray(x), *out_hw, align_corners=align))
    got = R.resize_bicubic(_t(x), *out_hw, align_corners=align).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_pixel_replicate_upsample_equal_jax(r):
    x = np.random.default_rng(2).random((2, 4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(R.pixel_replicate_upsample(_t(x), r).numpy(),
                                  np.asarray(JR.pixel_replicate_upsample(jnp.asarray(x), r)))


@pytest.mark.parametrize("src,dst", [((512, 512), (64, 64)), ((16, 16), (64, 64)),
                                     ((48, 40), (32, 32)), ((32, 32), (32, 32))])
def test_haze_template_resize_equal_jax(src, dst):
    """The template resize of the haze branch against jax.image.resize
    linear (antialiased when it downsamples), both ways."""
    a = np.random.default_rng(3).random((2,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(a), (2,) + dst, method="linear"))
    np.testing.assert_allclose(PD.jax_linear_resize(a, dst), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the deterministic applies on the draws of the JAX functions' own keys
# ---------------------------------------------------------------------------

def _jax_rank_mask(key, n, count):
    return np.asarray(jax.random.permutation(key, n) < count)


def _draws_stripe(key, c, w, amount=(0.05, 0.15)):
    kb, kc, kcols, kval = jax.random.split(key, 4)
    lo, hi = int(np.floor(amount[0] * w)), int(np.floor(amount[1] * w))
    counts = jax.random.randint(kc, (c,), lo, max(hi, lo + 1))
    ranks = jax.vmap(lambda k: jax.random.permutation(k, w))(jax.random.split(kcols, c))
    return (_jax_rank_mask(kb, c, c // 3), np.asarray(ranks < counts[:, None]),
            np.asarray(jax.random.uniform(kval, (c, w)) * 0.5 - 0.25))


def _draws_deadline(key, c, w, amount=(0.05, 0.15)):
    kb, kc, kcols = jax.random.split(key, 3)
    lo, hi = int(np.ceil(amount[0] * w)), int(np.ceil(amount[1] * w))
    counts = jax.random.randint(kc, (c,), lo, max(hi, lo + 1))
    ranks = jax.vmap(lambda k: jax.random.permutation(k, w))(jax.random.split(kcols, c))
    return (_jax_rank_mask(kb, c, c // 3)[:, None] & np.asarray(ranks < counts[:, None]),)


def _apply_cases():
    c, h, w = CUBE.shape
    key = jax.random.key(17)
    k1, k2 = jax.random.split(key)
    sig = np.asarray(jax.random.uniform(k1, (), minval=30, maxval=70) / 255.0)
    sigmas = (10, 30, 50, 70)
    bw = np.asarray((jnp.asarray(sigmas, jnp.float32) / 255.0)[
        jax.random.randint(k1, (c,), 0, len(sigmas))]).reshape(-1, 1, 1)
    noise = np.asarray(jax.random.normal(k2, CUBE.shape))
    kb, kf, ks = jax.random.split(key, 3)
    impulse = (_jax_rank_mask(kb, c, c // 3), np.asarray(jax.random.uniform(kf, CUBE.shape) < 0.3),
               np.asarray(jax.random.uniform(ks, CUBE.shape) < 0.5))
    cir = DN.default_cirrus(h, w, 2)
    mask = (np.random.default_rng(0).random((h, w)) > 0.5).astype(np.float32)
    x, jx = _t(CUBE), jnp.asarray(CUBE)
    return {
        "gaussian_iid": (lambda: D.gaussian_apply(x, _t(sig), _t(noise)),
                         lambda: JD.gaussian_noise_iid(key, jx, (30, 70)), 1e-6),
        "gaussian_non_iid": (lambda: D.gaussian_apply(x, _t(bw), _t(noise)),
                             lambda: JD.gaussian_noise_non_iid(key, jx, sigmas), 1e-6),
        "stripe": (lambda: D.stripe_apply(x, *map(_t, _draws_stripe(key, c, w))),
                   lambda: JD.stripe_noise(key, jx), 1e-6),
        "deadline": (lambda: D.deadline_apply(x, *map(_t, _draws_deadline(key, c, w))),
                     lambda: JD.deadline_noise(key, jx), 1e-6),
        "impulse": (lambda: D.impulse_apply(x, *map(_t, impulse)),
                    lambda: JD.impulse_noise(key, jx, 0.3), 1e-6),
        "poisson": (lambda: D.poisson_apply(_t(np.asarray(jax.random.poisson(
            key, jnp.clip(jx, 0.0, None) * 10.0))), 10.0),
            lambda: JD.poisson_noise(key, jx, 10.0), 1e-6),
        "random_mask": (lambda: D.mask_apply(x, _t(np.asarray(jax.random.uniform(key, CUBE.shape)
                                                                > 0.8))),
                        lambda: JD.random_mask(key, jx, 0.8), 1e-6),
        "band_loss": (lambda: D.band_apply(x, _t(~_jax_rank_mask(key, c, 3))),
                      lambda: JD.band_loss(key, jx, 0.25), 1e-6),
        "blur_gaussian_15": (lambda: D.apply_blur(x, _t(DN.gaussian_blur_kernel(15))),
                             lambda: JD.gaussian_blur(jx, 15), 1e-5),
        "blur_circle_9": (lambda: D.apply_blur(x, _t(DN.circle_blur_kernel(9))),
                          lambda: JD.circle_blur(jx, 9), 1e-5),
        "blur_motion": (lambda: D.apply_blur(x, _t(DN.motion_blur_kernel(15, 45))),
                        lambda: JD.motion_blur(jx, 15, 45), 1e-5),
        "sr_2": (lambda: D.sr_degrade(x, 2), lambda: JD.sr_degrade(jx, 2), 1e-6),
        "sr_8": (lambda: D.sr_degrade(x, 8), lambda: JD.sr_degrade(jx, 8), 1e-6),
        "haze": (lambda: D.simulate_haze(x, _t(cir), float(np.float32(0.75))),
                 lambda: JD.simulate_haze(jx, jnp.asarray(cir), jnp.float32(0.75)), 1e-6),
        "sd_cassi": (lambda: D.sd_cassi(x, _t(mask)), lambda: JD.sd_cassi(jx, jnp.asarray(mask)),
                     1e-6),
    }


@pytest.mark.parametrize("name", sorted(_apply_cases()))
def test_apply_equals_jax_on_its_draws(name):
    got, want, tol = _apply_cases()[name]
    np.testing.assert_allclose(got().numpy(), np.asarray(want()), rtol=0, atol=tol)


@pytest.mark.parametrize("mode", range(8))
def test_augment_modes_equal_jax(mode):
    x = np.random.default_rng(mode).random((3, 8, 8)).astype(np.float32)
    want = np.asarray(JPD._augment_one(jnp.asarray(x), mode))
    np.testing.assert_array_equal(PD._augment_one(_t(x), mode).numpy(), want)


def test_batched_augment_is_each_mode():
    x = torch.from_numpy(np.random.default_rng(1).random((8, 3, 8, 8)).astype(np.float32))
    modes = torch.tensor([3, 0, 7, 1, 5, 2, 6, 4])
    got = PD.augment(x, modes)
    for j, m in enumerate(modes.tolist()):
        assert torch.equal(got[j], PD._augment_one(x[j], m))


# ---------------------------------------------------------------------------
# utils/image.py
# ---------------------------------------------------------------------------

def test_image_utils_equal_jax():
    rng = np.random.default_rng(6)
    cube = rng.random((9, 70, 66)).astype(np.float32)
    np.testing.assert_array_equal(I.crop_to_multiple(cube, 32), JI.crop_to_multiple(cube, 32))
    np.testing.assert_array_equal(I.crop_to_multiple(cube[0], 64), JI.crop_to_multiple(cube[0], 64))
    for bands in (31, 100, 9):
        np.testing.assert_array_equal(I.interpolate_bands(cube, bands),
                                      JI.interpolate_bands(cube, bands))
    np.testing.assert_array_equal(I.rand_crop(cube, 32, 16, np.random.default_rng(3)),
                                  JI.rand_crop(cube, 32, 16, np.random.default_rng(3)))
    np.testing.assert_array_equal(I.crop_center(cube, 32, 16), JI.crop_center(cube, 32, 16))
    np.testing.assert_array_equal(I.minmax_normalize(cube), JI.minmax_normalize(cube))


# ---------------------------------------------------------------------------
# the port's own draws, by distribution
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


X = torch.from_numpy(np.stack([CUBE] * 4))  # (4, 12, 32, 32)


def test_gaussian_iid_sigma_range():
    sigma, noise = D.gaussian_iid_draw(_gen(0), X, (30, 70))
    y = D.gaussian_apply(X, sigma, noise)
    s = (y - X).flatten(1).std(dim=1)
    assert ((s > 25 / 255) & (s < 75 / 255)).all()
    assert ((sigma >= 30 / 255) & (sigma < 70 / 255)).all()


def test_gaussian_non_iid_band_structure():
    bw, noise = D.gaussian_non_iid_draw(_gen(1), X, (10, 70))
    per_band = (D.gaussian_apply(X, bw, noise) - X).std(dim=(2, 3))
    close = ((per_band - 10 / 255).abs() < 0.01) | ((per_band - 70 / 255).abs() < 0.02)
    assert close.float().mean() > 0.9


def test_stripe_third_of_bands_column_constant():
    y = D.stripe_apply(X, *D.stripe_draw(_gen(2), X))
    changed = (y != X).flatten(2).any(dim=2)
    assert (changed.sum(dim=1) == 12 // 3).all()
    delta = y - X
    assert float(delta.std(dim=2).max()) < 1e-6  # constant along H in every column
    cols = (delta != 0).any(dim=2).sum(dim=2)  # struck columns per band
    struck = cols[changed]
    assert ((struck >= int(np.floor(0.05 * 32))) & (struck < int(np.floor(0.15 * 32)))).all()


def test_deadline_zeroes_columns():
    y = D.deadline_apply(X, *D.deadline_draw(_gen(3), X))
    changed = (y != X).flatten(2).any(dim=2)
    assert (changed.sum(dim=1) == 4).all()
    dead = (y == 0).all(dim=2).sum(dim=2)[changed]
    assert ((dead >= int(np.ceil(0.05 * 32))) & (dead < int(np.ceil(0.15 * 32)))).all()


def test_impulse_rate():
    y = D.impulse_apply(X, *D.impulse_draw(_gen(4), X, 0.5))
    changed = (y != X).flatten(2).any(dim=2)
    assert (changed.sum(dim=1) == 4).all()
    vals = y[changed]
    frac = ((vals == 0) | (vals == 1)).float().mean().item()
    assert 0.45 < frac < 0.55


def test_poisson_distribution():
    y = D.poisson_apply(*D.poisson_draw(_gen(5), X, 10.0), 10.0)
    assert abs(float(y.mean() - X.mean())) < 0.02
    assert torch.equal(torch.round(y * 10), y * 10)  # quantised to 1/scale
    assert abs(float((y - X).var()) - float(X.mean()) / 10) < 0.005  # variance lambda / scale^2


def test_random_mask_rate():
    y = D.mask_apply(X, *D.random_mask_draw(_gen(6), X, 0.9))
    assert 0.88 < (y == 0).float().mean().item() < 0.92


def test_band_loss_count():
    y = D.band_apply(X, *D.band_loss_draw(_gen(7), X, 3))
    assert ((y == 0).all(dim=(2, 3)).sum(dim=1) == 3).all()


def test_draws_reproducible():
    a = D.stripe_draw(_gen(9), X)
    b = D.stripe_draw(_gen(9), X)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# ---------------------------------------------------------------------------
# the degrader: every branch, and grouping keeps each sample's identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_type", ["natural_scene", "remote_sensing"])
def test_every_branch_runs(data_type):
    types = tuple(PD.TABLES[data_type])
    deg = PD.make_degrader(types, data_type, np.stack([DN.default_cirrus(32, 32, s) for s in range(2)]))
    x = torch.from_numpy(np.stack([CUBE[:10]] * 2))
    for br in deg.branches:
        for sub in range(br.n_sub):
            for sub2 in range(br.n_sub2[sub] if br.n_sub2 else 1):
                y = br(_gen(sub), x, sub, sub2)
                assert y.shape == x.shape and torch.isfinite(y).all(), br.name
                assert (y - x).abs().max() > 1e-4, br.name


def test_grouping_keeps_sample_identity():
    """Deterministic branches run per group and scatter back: sample j is
    its own clean cube through its own task and choice."""
    deg = PD.make_degrader(("sr", "blur"), "natural_scene")
    rng = np.random.default_rng(0)
    clean = torch.from_numpy(rng.random((7, 4, 32, 32)).astype(np.float32))
    de_ids = np.array([1, 0, 1, 0, 0, 1, 1])
    choices = deg.choices(de_ids, rng.random((7, 2)))
    got = deg(_gen(0), clean, de_ids, choices)
    for j in range(7):
        br = deg.branches[de_ids[j]]
        want = br(_gen(0), clean[j:j + 1], int(choices[j, 0]), int(choices[j, 1]))
        torch.testing.assert_close(got[j:j + 1], want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# patch store and builders
# ---------------------------------------------------------------------------

def _write(writer_cls, path, patches):
    with writer_cls(str(path)) as w:
        for i, (p, src) in enumerate(patches):
            w.add(p, src)


def _patches():
    rng = np.random.default_rng(11)
    srcs = ["WDC_a.mat", "ICVL_b.mat", "Chikusei_c.mat", "ARAD_d.mat", "WDC_e.mat"]
    return [(rng.random((6, 16, 16)).astype(np.float32), s) for s in srcs]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_patch_store_cross_read(tmp_path, writer):
    from mp_hsir_tpu.data import patch_store as JS
    from mp_hsir_tpu_torch.data import patch_store as TS

    patches = _patches()
    _write(JS.PatchStoreWriter, tmp_path / "jax", patches)
    _write(TS.PatchStoreWriter, tmp_path / "port", patches)
    for name in ("data.bin", "meta_info.txt", "offsets.npy"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    path = str(tmp_path / writer)
    for names in (TS.DEFAULT_DATASET_NAMES, TS.NATURAL_DATASET_NAMES, None, ("Nothing",)):
        a, b = TS.PatchStore(path, dataset_names=names), JS.PatchStore(path, dataset_names=names)
        np.testing.assert_array_equal(a.valid_idx, b.valid_idx)
        np.testing.assert_array_equal(a.gather(np.arange(len(a))), b.gather(np.arange(len(b))))
        assert [a.source_of(i) for i in range(len(a))] == [b.source_of(i) for i in range(len(b))]
    assert (TS.DEFAULT_DATASET_NAMES, TS.NATURAL_DATASET_NAMES) == (JS.DEFAULT_DATASET_NAMES,
                                                                   JS.NATURAL_DATASET_NAMES)


def test_builders_equal_jax(tmp_path):
    from mp_hsir_tpu.data import builders as JB
    from mp_hsir_tpu_torch.data import builders as TB

    mats = tmp_path / "mats"
    rng = np.random.default_rng(12)
    JI.save_mat_cube(str(mats / "WDC_x.mat"), rng.random((130, 140, 12)).astype(np.float32))
    JI.save_mat_cube(str(mats / "Houston_y.mat"), rng.random((128, 128, 9)).astype(np.float32))
    n_j = JB.build_patch_store(str(mats), str(tmp_path / "j"), remote_sensing=True)
    n_t = TB.build_patch_store(str(mats), str(tmp_path / "t"), remote_sensing=True)
    assert n_j == n_t > 0
    for name in ("data.bin", "meta_info.txt", "offsets.npy"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    cube = rng.random((12, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(TB.resample_to_common_grid(cube, (400, 2400)),
                                  JB.resample_to_common_grid(cube, (400, 2400)))
    assert TB.make_train_test_split(str(mats), ["WDC_x.mat"]) == JB.make_train_test_split(
        str(mats), ["WDC_x.mat"])


def test_tensorboard_records_equal_jax(tmp_path, monkeypatch):
    """Both writers' event records, byte for byte, at one wall time."""
    from mp_hsir_tpu.utils import tboard as JT
    from mp_hsir_tpu_torch.utils import tboard as TT

    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    files = []
    for mod, d in ((JT, tmp_path / "j"), (TT, tmp_path / "t")):
        w = mod.SummaryWriter(str(d))
        for step, v in ((1, 0.5), (2, 0.25), (300, -1.5e-3)):
            w.add_scalar("train_loss", v, step)
        w.close()
        (name,) = os.listdir(d)
        files.append((d / name).read_bytes())
    assert files[0] == files[1] and len(files[0]) > 100
