"""The row-sharded eval forward of the PyTorch port (``--mesh_spatial N``)
on the CPU: the spectral stats and apply plain versions with a shard's halo
rows against the JAX package's shard kernels ``_sp0_call`` / ``_sp1_call``
in interpret mode (every edge-flag combination, with and without the
LayerNorm, the gate, the per-pixel gate map, the PromptFusion entry); the
sharded ops, the tiny model and the
eval CLI over gloo ranks spawned on this machine (three spawned runs)
against the unsharded port and the JAX package; the rank -> card mapping.
The halo tiles themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 15). The sharded train
step's backward is tests/test_torch_mesh_train.py's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: E402,F401  (one compute thread per process)
from mp_hsir_tpu.ops.pallas_attention import _sp0_call, _sp1_call
from mp_hsir_tpu_torch.config import ModelConfig
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    Halo, spectral_apply, spectral_apply_plain, spectral_stats, spectral_stats_plain,
)
from mp_hsir_tpu_torch.parallel import distributed
from mp_hsir_tpu_torch.parallel.distributed import card_for_rank, pick_backend
from torch_port_inputs import normal, rng, tensor, uniform

EDGES = [(True, True), (True, False), (False, True), (False, False)]
TOL = 1e-5
TINY = dict(in_channels=31, out_channels=31, dim=16, num_blocks=(1, 1, 1),
            num_refinement_blocks=1, heads=(2, 2, 2), task_classes=6)


def _shard(seed, c, heads, c2=0):
    """A 16 x 16 shard of cat(x, x2) (C = c + c2), its halo rows, weights in
    both layouts."""
    r = rng(seed)
    cc = c + c2
    d = dict(x=normal(r, (1, 16, 16, c)), x2=normal(r, (1, 16, 16, c2)) if c2 else None,
             top=normal(r, (1, 1, 16, cc)), bot=normal(r, (1, 1, 16, cc)),
             wqkv=uniform(r, (cc, 3 * cc), cc), wdw=uniform(r, (9, 3 * cc), 9),
             ln_w=1 + normal(r, (cc,), 0.1), ln_b=normal(r, (cc,), 0.1),
             comb=normal(r, (1, cc, cc), cc ** -0.5), gate=normal(r, (1, 2, 2, cc), 0.5),
             gmap=normal(r, (1, 16, 16, cc), 0.5), short=normal(r, (1, 16, 16, cc)))
    # the port's torch layouts: wqkv (3C, C, 1, 1), wdw (3C, 1, 3, 3)
    d["wqkv_t"] = tensor(d["wqkv"].T.reshape(3 * cc, cc, 1, 1))
    d["wdw_t"] = tensor(d["wdw"].T.reshape(3 * cc, 1, 3, 3))
    return d


def _halo(d, edges):
    return Halo(tensor(d["top"]), tensor(d["bot"]), *edges)


def _jax_args(d, edges):
    x = d["x"] if d["x2"] is None else np.concatenate([d["x"], d["x2"]], -1)
    return (jnp.asarray(x), jnp.asarray(d["top"]), jnp.asarray(d["bot"]),
            jnp.asarray(np.array(edges, np.int32)), jnp.asarray(d["wqkv"]), jnp.asarray(d["wdw"]))


@pytest.mark.parametrize("ln", [False, True], ids=["raw", "ln"])
@pytest.mark.parametrize("edges", EDGES, ids=lambda e: f"edge{int(e[0])}{int(e[1])}")
def test_stats_halo_plain_matches_jax_sp0(edges, ln):
    """spectral_stats_plain on a shard with its halo rows and edge flags ==
    _sp0_call (interpret mode): the Gram and both norms."""
    d = _shard(11, 16, 2)
    kw = dict(ln_w=tensor(d["ln_w"]), ln_b=tensor(d["ln_b"])) if ln else {}
    got = spectral_stats_plain(tensor(d["x"]), d["wqkv_t"], d["wdw_t"], 2, halo=_halo(d, edges),
                               **kw)
    want = _sp0_call(*_jax_args(d, edges), jnp.asarray(d["ln_w"]) if ln else None,
                     jnp.asarray(d["ln_b"]) if ln else None, num_heads=2, eps=1e-5,
                     interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("variant", ["gate", "gate_map", "fusion"])
@pytest.mark.parametrize("edges", EDGES, ids=lambda e: f"edge{int(e[0])}{int(e[1])}")
def test_apply_halo_plain_matches_jax_sp1(edges, variant):
    """spectral_apply_plain on a shard with its halo rows == _sp1_call
    (interpret mode): the PGSSTB epilogue with per-window gates and a
    shortcut; a shifted block's per-pixel gate map with a shortcut; the
    PromptFusion entry
    cat(x, x2) with the LayerNorm and the residual."""
    d = _shard(12, 16, 2, c2=16 if variant == "fusion" else 0)
    x = tensor(d["x"])
    halo = _halo(d, edges)
    comb, wq, wd = tensor(d["comb"]), d["wqkv_t"], d["wdw_t"]
    jargs = _jax_args(d, edges) + (jnp.asarray(d["comb"]),)
    none4 = (None, None, None, None)
    if variant == "gate":
        got = spectral_apply_plain(x, comb, wq, wd, gate=tensor(d["gate"]),
                                   shortcut=tensor(d["short"]), halo=halo)
        want = _sp1_call(*jargs, None, None, jnp.asarray(d["gate"]), None, jnp.asarray(d["short"]),
                         None, num_heads=2, eps=1e-5, residual=False, interpret=True)
    elif variant == "gate_map":
        got = spectral_apply_plain(x, comb, wq, wd, gate=tensor(d["gmap"]),
                                   shortcut=tensor(d["short"]), halo=halo)
        want = _sp1_call(*jargs, None, None, None, jnp.asarray(d["gmap"]), jnp.asarray(d["short"]),
                         None, num_heads=2, eps=1e-5, residual=False, interpret=True)
    else:
        got = spectral_apply_plain(x, comb, wq, wd, x2=tensor(d["x2"]), ln_w=tensor(d["ln_w"]),
                                   ln_b=tensor(d["ln_b"]), residual=True, halo=halo)
        want = _sp1_call(*jargs, jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"]), *none4,
                         num_heads=2, eps=1e-5, residual=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_spectral_fold_matches_jax_sharded_fold():
    """The port's fold between the two launches == spectral_sharded_fold
    (the fold between the sharded route's phases), on summed stats."""
    from mp_hsir_tpu.ops.pallas_attention import spectral_sharded_fold
    from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_fold

    r = rng(15)
    c, heads = 32, 4
    gram = normal(r, (2, c, c // heads), 4.0)
    nq, nk = (np.abs(normal(r, (2, heads, c // heads), 9.0)) + 1 for _ in range(2))
    temp, wout = 1 + normal(r, (heads, 1, 1), 0.2), uniform(r, (1, 1, c, c), c)
    got = spectral_fold(tensor(gram), tensor(nq), tensor(nk), tensor(temp),
                        tensor(np.transpose(wout, (3, 2, 0, 1))))
    want = spectral_sharded_fold(jnp.asarray(gram), jnp.asarray(nq), jnp.asarray(nk),
                                 jnp.asarray(temp), jnp.asarray(wout), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_halo_options_the_wrappers_refuse():
    """Halo rows take shift 0 (a shard is read in its own frame); on the CPU
    the wrappers run the plain versions, which hold to that. The backward
    through halo rows: the wrapper's explicit backward (the halo
    cotangents of K10b's plain version) == autograd through the plain
    forward, for x and both halo rows."""
    d = _shard(13, 16, 2)
    halo = _halo(d, (False, False))
    with pytest.raises(ValueError, match="shift 0"):
        spectral_stats(tensor(d["x"]), d["wqkv_t"], d["wdw_t"], 2, shift=4, halo=halo)
    cot = tensor(rng(16).standard_normal(d["x"].shape))
    grads = []
    for fn in (spectral_apply, spectral_apply_plain):
        x, top, bot = (tensor(d[k]).requires_grad_() for k in ("x", "top", "bot"))
        y = fn(x, tensor(d["comb"]), d["wqkv_t"], d["wdw_t"], halo=Halo(top, bot, False, False))
        (y * cot).sum().backward()
        grads.append([t.grad for t in (x, top, bot)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_edge_rows_are_zero_after_the_layernorm():
    """At both image edges the halo rows' contents do not matter: the call
    equals the unsharded one on the shard alone (zero padding after LN)."""
    d = _shard(14, 16, 2)
    x, ln = tensor(d["x"]), dict(ln_w=tensor(d["ln_w"]), ln_b=tensor(d["ln_b"]))
    got = spectral_stats_plain(x, d["wqkv_t"], d["wdw_t"], 2, halo=_halo(d, (True, True)), **ln)
    want = spectral_stats_plain(x, d["wqkv_t"], d["wdw_t"], 2, **ln)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("local_rank,n_cards,card", [(0, 1, 0), (1, 1, 0), (3, 1, 0), (1, 4, 1),
                                                     (5, 4, 1), (7, 8, 7)])
def test_rank_to_card(local_rank, n_cards, card):
    """Rank r runs on card r where there are enough, else the ranks share
    them round robin (a one-card machine: all on card 0)."""
    assert card_for_rank(local_rank, n_cards) == card


@pytest.mark.parametrize("device,local_world,n_cards,backend", [
    ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"), ("cuda", 8, 4, "gloo"),
    ("cpu", 2, 0, "gloo")])
def test_backend_choice(device, local_world, n_cards, backend):
    """NCCL only where every rank of the machine has a card of its own."""
    assert pick_backend(device, local_world, n_cards) == backend


def test_rank_to_card_without_a_card():
    with pytest.raises(ValueError):
        card_for_rank(0, 0)


# --- spawned gloo ranks (three runs) ---------------------------------------

def test_sharded_ops_match_jax_over_four_ranks():
    """Over 4 gloo ranks, gathered: roll_hw by (-4, -4) and (4, 4) (JAX's
    roll_hw on the whole map), the halo 3x3 conv and depthwise conv (JAX's
    conv2d with zero padding), the bilinear resize's row blocks (JAX's
    resize_bilinear), CrossAttention with halo'd depthwise convs and summed
    statistics, and the sharded spectral attention (the unsharded port,
    stats + fold + apply) — the ops of test_ops_parity.py's sharded cases."""
    from mp_hsir_tpu.ops.conv import conv2d as jconv
    from mp_hsir_tpu.ops.resize import resize_bilinear as jresize
    from mp_hsir_tpu.ops.window import roll_hw as jroll
    from mp_hsir_tpu_torch.models.layers import CrossAttention, SpectralAttention
    from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_apply as apply_

    r = rng(21)
    x_roll = normal(r, (2, 32, 8, 3))
    x_conv = normal(r, (1, 32, 16, 4))
    w_conv = normal(r, (8, 4, 3, 3), 0.1)
    w_dw = normal(r, (4, 1, 3, 3), 0.3)
    prompts = normal(r, (1, 6, 5, 3))
    torch.manual_seed(0)
    cross = CrossAttention(8, 2)
    ca = dict(c=8, state={k: v.numpy() for k, v in cross.state_dict().items()},
              q=normal(r, (1, 32, 8, 8)), kv=normal(r, (1, 32, 8, 8)))
    sa = SpectralAttention(8, 2)
    sp = dict(x=normal(r, (1, 32, 8, 8)), wqkv=sa.qkv.weight.detach().numpy(),
              wdw=sa.qkv_dwconv.weight.detach().numpy(), temp=1 + normal(r, (2, 1, 1), 0.2),
              wout=sa.project_out.weight.detach().numpy(), gate=normal(r, (1, 4, 1, 8), 0.5),
              short=normal(r, (1, 32, 8, 8)))
    from torch_mesh_ranks import ops_rank

    got = distributed.spawn(ops_rank, 4, x_roll, x_conv, w_conv, w_dw, prompts, ca, sp,
                            device="cpu")
    for sh in (-4, 4):
        np.testing.assert_array_equal(got[f"roll{sh}"], np.asarray(jroll(jnp.asarray(x_roll),
                                                                         sh, sh)))
    hwio = lambda w: jnp.asarray(np.transpose(w, (2, 3, 1, 0)))  # noqa: E731
    np.testing.assert_allclose(got["conv"], np.asarray(jconv(jnp.asarray(x_conv), hwio(w_conv),
                                                              padding=1)), atol=1e-5)
    np.testing.assert_allclose(got["dwconv"], np.asarray(jconv(
        jnp.asarray(x_conv), hwio(w_dw), padding=1, groups=4)), atol=1e-5)
    np.testing.assert_allclose(got["resize"], np.asarray(jresize(jnp.asarray(prompts), 24, 20)),
                               atol=1e-6)
    with torch.no_grad():
        want = cross(tensor(ca["q"]), tensor(ca["kv"])).numpy()
        g = {k: tensor(v) for k, v in sp.items()}
        sa.temperature.copy_(g["temp"])
        want_sp = apply_(g["x"], sa.comb(g["x"]), g["wqkv"], g["wdw"], gate=g["gate"],
                         shortcut=g["short"]).numpy()
    np.testing.assert_allclose(got["cross"], want, atol=1e-5)
    np.testing.assert_allclose(got["spectral"], want_sp, atol=1e-5)


def test_sharded_tiny_model_matches_unsharded_and_jax():
    """The tiny model's eval step over 2 gloo ranks at 64 x 64 (rows 32 a
    rank, make_eval_step on a 1 x 2 mesh) against the port's unsharded
    forward (2e-5, the model's bar) and JAX's make_eval_step(TINY,
    make_mesh(1, 2)) on the same weights (1e-4)."""
    from flax import traverse_util

    from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
    from mp_hsir_tpu.models.mp_hsir import init_params
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu.training.trainer import make_eval_step as jax_step
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from torch_mesh_ranks import model_rank

    if len(jax.devices()) < 2:
        pytest.skip("JAX's sharded step needs 2 devices")
    jc = JaxModelConfig(**TINY)
    params = init_params(jc, jax.random.key(0), sample_hw=64)
    x = rng(5).random((1, 31, 64, 64)).astype(np.float32)
    want_jax = np.asarray(jax_step(jc, jax_mesh(1, 2))(params, jnp.asarray(x),
                                                       jnp.asarray([0], jnp.int32)))
    cfg = ModelConfig(**TINY)
    model = build_model(cfg, device="cpu")
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    state = params_from_jax(flat, model.state_dict())
    model.load_state_dict(state)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), torch.tensor([0])).numpy()
    got = distributed.spawn(model_rank, 2, cfg, {k: v.numpy() for k, v in state.items()}, x,
                            [0], device="cpu")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, want_jax, atol=1e-4, rtol=0)


def test_eval_cli_mesh_spatial_matches_one_rank(tmp_path):
    """The port's CLI with --mesh_spatial 2 (2 ranks it spawns, gloo on the
    CPU) against --mesh_spatial 1 on tests/test_eval_cli.py's tiny cube:
    PSNR within 1e-3 dB, SSIM within 1e-4 (that test's bars); the same
    stdout lines from rank 0 alone."""
    from mp_hsir_tpu_torch.cli import test_cli
    from mp_hsir_tpu_torch.utils.image import save_mat_cube

    d = tmp_path / "cubes"
    d.mkdir()
    base = np.random.default_rng(0).uniform(0.2, 0.8, (31, 8, 8)).astype(np.float32)
    save_mat_cube(str(d / "cube_0.mat"), np.stack([np.kron(b, np.ones((8, 8), np.float32))
                                                   for b in base]))
    argv = ["--mode", "0", "--test_dir", str(d), "--device", "cpu", "--dim", "16",
            "--num_blocks", "1", "1", "1", "--no_save_images", "--output_path",
            str(tmp_path / "out")]
    one = test_cli.main(argv)
    two = test_cli.main(argv + ["--mesh_spatial", "2"])
    assert np.isfinite(one["psnr"]) and np.isfinite(two["psnr"])
    np.testing.assert_allclose(two["psnr"], one["psnr"], atol=1e-3)
    np.testing.assert_allclose(two["ssim"], one["ssim"], atol=1e-4)
    assert len(two["ranks"]) == 2 and all(r["forwards"] == 2 for r in two["ranks"])
