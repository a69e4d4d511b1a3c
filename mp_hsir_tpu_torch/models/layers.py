"""Building blocks of MP-HSIR as ``nn.Module``s over NHWC tensors
(counterparts of ``mp_hsir_tpu/models/layers.py``). ``module.train()`` runs
the training route and ``module.eval()`` the eval route, as JAX switches on
``deterministic``.

Attribute names mirror the flax module names, so a state_dict key is the
flax parameter path with '.' for '/'. Layouts are PyTorch's: Linear weights
(out, in), conv weights OIHW; ``checkpoint.params_from_jax`` converts.

Every PGSSTB, TransformerBlock and 3x3 conv goes through the kernel wrappers
of ``ops/kernels``; they run the CUDA kernels on the card and their plain
versions on the CPU, so both devices take the same route through this code.
The wrappers are ``torch.autograd.Function``s with backward kernels; the
eval route's fused extras (the apply kernel's MLP tail, PromptFusion's
in-kernel concat and exit conv) have no backward, as in JAX.

Row shards: the ``axis`` argument (a
:class:`~mp_hsir_tpu_torch.parallel.mesh.Axis`, None on one device) says
that the map's H is split over the spatial mesh axis, as JAX's
``axis_name`` does. The same kernels run on each shard, on both routes:
the spectral tiles with the neighbours' halo rows and the summed
statistics, the window tile on rows rolled across the shards with the
global map's region labels, and the 3x3 convs and GDFN over the shard
extended by a neighbour row on each inner side
(:func:`~mp_hsir_tpu_torch.ops.conv.extend_rows`), cropped after. The
collectives are differentiable, so the training route's backward sends
each halo row's cotangent back to the shard that owns the row.

Head-parallel spectral attention: the ``spectral`` argument (the spectral
mesh axis, None on one device) runs every spectral attention whose heads
the axis divides as its members' head blocks (JAX's ``spectral_axis``,
``models/layers.py:436-470``): each member slices its heads' weights
(``parallel/tp.py``), runs the stats and apply kernels on them, and the
partial outputs are summed over the axis; everything else runs whole on
every member. A PGSSTB then runs JAX's TP epilogue (the apply with the gate
over n and the drop-path scale, the shortcut after the sum, then the MLP
kernel with its residual), a TransformerBlock JAX's unfused route (a plain
LayerNorm, the TP attention, the residual, then the GDFN kernel) and
PromptFusion its explicit concat and exit conv. A block whose heads the
axis does not divide runs its whole attention on every member (JAX's
replicated route).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.conv import conv2d, depthwise_conv2d, extend_rows
from mp_hsir_tpu_torch.ops.kernels.conv3 import conv3
from mp_hsir_tpu_torch.ops.kernels.gdfn import gdfn
from mp_hsir_tpu_torch.ops.kernels.mlp import mlp
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    spectral_apply, spectral_attention_sharded, spectral_attention_tp, spectral_fold,
    spectral_stats,
)
from mp_hsir_tpu_torch.ops.kernels.window_attention import (
    region_labels, relative_position_index, window_attention,
)
from mp_hsir_tpu_torch.ops.kernels.window_msa import window_msa
from mp_hsir_tpu_torch.ops.resize import (
    resize_bilinear, resize_bilinear_row_block, resize_nearest,
)
from mp_hsir_tpu_torch.ops.window import roll_hw
from mp_hsir_tpu_torch.parallel.mesh import axis_index, axis_size, psum
from mp_hsir_tpu_torch.parallel.tp import divides, head_block

# Route counters (counterpart of FUSED_PATH_STATS): how many blocks of each
# kind took the kernel route in the forwards since the last reset.
PATH_STATS: dict = {}


def reset_path_stats() -> None:
    PATH_STATS.clear()


def _count_path(name: str) -> None:
    PATH_STATS[name] = PATH_STATS.get(name, 0) + 1


def _sharded(axis) -> bool:
    return axis_size(axis) > 1


def _on_extended_rows(fn, x, axis, scale: float = 1, res=None):
    """fn over a row shard extended by a neighbour row on each inner side
    (:func:`~mp_hsir_tpu_torch.ops.conv.extend_rows`), its output cropped
    back to the shard; ``scale``: output rows per input row. ``res`` (the
    conv's residual) is extended by zero rows, which the crop drops."""
    xe, top, bot = extend_rows(x, axis)
    if res is not None:
        res = torch.nn.functional.pad(res, (0, 0, 0, 0, top, bot))
    y = fn(xe) if res is None else fn(xe, res)
    return y[:, int(top * scale):y.shape[1] - int(bot * scale)].contiguous()


def _uniform_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.init.uniform_(t, -bound, bound)


class Linear(nn.Module):
    """torch nn.Linear layout (weight (out, in)); computes in x's dtype."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(_uniform_(torch.empty(cout, cin), cin))
        self.bias = nn.Parameter(_uniform_(torch.empty(cout), cin)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.to(x.dtype).t()
        return y if self.bias is None else y + self.bias.to(y.dtype)


class Conv2d(nn.Module):
    """Conv weight holder, OIHW; ``forward`` is the plain NHWC conv."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, groups: int = 1, bias: bool = False):
        super().__init__()
        fan_in = (cin // groups) * kernel * kernel
        self.padding = kernel // 2
        self.groups = groups
        self.weight = nn.Parameter(_uniform_(torch.empty(cout, cin // groups, kernel, kernel), fan_in))
        self.bias = nn.Parameter(_uniform_(torch.empty(cout), fan_in)) if bias else None

    def forward(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, padding=self.padding, groups=self.groups,
                      axis=axis)


class LayerNorm(nn.Module):
    """Channels-last LayerNorm (torch nn.LayerNorm and the Restormer
    WithBias_LayerNorm semantics)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class DropPath(nn.Module):
    """Per-sample stochastic depth (counterpart of ``DropPath``,
    ``mp_hsir_tpu/models/layers.py:202``): :meth:`scales` draws the (B,)
    float32 scales, 1/keep or 0, from an explicit ``torch.Generator``. The
    kernels apply them in-kernel; the numbers differ from JAX's (another
    generator), the distribution is the same."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def scales(self, b: int, generator: torch.Generator | None, device) -> torch.Tensor:
        keep = 1.0 - self.rate
        mask = torch.bernoulli(torch.full((b,), keep, device=device), generator=generator)
        return mask / keep


class GatedMlp(nn.Module):
    """Token MLP with a gated exact GELU, ``fc2(a * gelu(g))`` with
    ``[a|g] = fc1(x)`` (reference net/MP_HSIR.py:66-82). On the eval route
    its weights ride the spectral apply kernel's tail; on the training route
    the MLP kernel runs it with the residual and drop-path scale."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden * 2)
        self.fc2 = Linear(hidden, dim)


class GDFN(nn.Module):
    """Gated-dconv FFN (reference net/MP_HSIR.py:374-391), bias-free."""

    def __init__(self, dim: int, expansion: float):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv2d(dim, hidden * 2, 1)
        self.dwconv = Conv2d(hidden * 2, hidden * 2, 3, groups=hidden * 2)
        self.project_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        x = self.dwconv(self.project_in(x), axis)
        x1, x2 = x.chunk(2, dim=-1)
        return self.project_out(gelu_exact(x1) * x2)


class SpectralAttention(nn.Module):
    """Transposed C x C attention (MDTA, reference net/MP_HSIR.py:85-114).
    The eval route runs it as stats kernel -> fold -> apply kernel."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Conv2d(dim, dim * 3, 1)
        self.qkv_dwconv = Conv2d(dim * 3, dim * 3, 3, groups=dim * 3)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = Conv2d(dim, dim, 1)

    def comb(self, x, shift=0, x2=None, ln=None):
        """Statistics + fold: the (B, C, C) matrix the apply kernel uses."""
        lnw, lnb = (None, None) if ln is None else (ln.weight, ln.bias)
        gram, nq, nk = spectral_stats(x, self.qkv.weight, self.qkv_dwconv.weight,
                                      self.num_heads, shift=shift, x2=x2, ln_w=lnw, ln_b=lnb)
        return spectral_fold(gram, nq, nk, self.temperature, self.project_out.weight)

    def sharded(self, x, axis, x2=None, ln=None, **epilogue):
        """The whole attention on a row shard over ``axis`` (JAX's sharded
        route, ``models/layers.py:425-435``): halo rows, the stats summed
        over the axis, the fold, the apply with ``epilogue``
        (:func:`~mp_hsir_tpu_torch.ops.kernels.spectral.spectral_apply`'s
        options); differentiable without x2 and the tail MLP."""
        lnw, lnb = (None, None) if ln is None else (ln.weight, ln.bias)
        return spectral_attention_sharded(x, self.qkv.weight, self.qkv_dwconv.weight,
                                          self.temperature, self.project_out.weight,
                                          self.num_heads, axis, x2=x2, ln_w=lnw, ln_b=lnb,
                                          **epilogue)

    def tp(self, x, spectral, axis=None, **epilogue):
        """The attention head-parallel over the ``spectral`` mesh axis (JAX's
        TP route, ``models/layers.py:436-470``): this member's head block of
        the weights, the stats and apply kernels on it (with the halo rows
        and summed statistics of ``axis`` when x is a row shard), the
        partial outputs summed over the axis; ``epilogue``: gate, shortcut,
        dp_scale (:func:`~mp_hsir_tpu_torch.ops.kernels.spectral.spectral_attention_tp`).
        Differentiable."""
        hb = head_block(self.qkv.weight, self.qkv_dwconv.weight, self.temperature,
                        self.project_out.weight, self.num_heads, spectral)
        return spectral_attention_tp(x, hb.wqkv, hb.wdw, hb.temperature, hb.wout, hb.heads,
                                     spectral, axis, **epilogue)


class PGSpectralAttention(nn.Module):
    """Prompt-guided local spectral attention on per-window means (reference
    net/MP_HSIR.py:116-155); returns the per-window gates."""

    def __init__(self, dim: int, compress_ratio: int, prompt_len: int):
        super().__init__()
        cr = dim // compress_ratio
        self.cr = cr
        self.linear_prompt = Linear(dim, prompt_len, bias=False)
        self.linear_down = Linear(dim, cr, bias=False)
        self.prompt_param = nn.Parameter(torch.rand(1, 1, prompt_len, cr))
        self.q = Linear(cr, cr, bias=False)
        self.kv = Linear(cr, 2 * cr, bias=False)
        self.proj = Linear(cr, cr, bias=True)
        self.linear_up = Linear(cr, dim, bias=False)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        bt = pooled.shape
        p = pooled.reshape(bt[0] * bt[1], 1, bt[2])
        dt = p.dtype
        pw = torch.softmax(self.linear_prompt(p).float(), dim=-1).to(dt)
        down = self.linear_down(p)
        prompt = torch.einsum("bol,olr->bor", pw, self.prompt_param[0].to(dt))
        q = self.q(prompt)
        k, v = self.kv(down).chunk(2, dim=-1)
        attn = torch.einsum("boi,boj->bij", q.float(), k.float()) * self.cr ** -0.5
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.einsum("bij,boj->boi", attn, v)
        return self.linear_up(self.proj(out)).reshape(bt)


class SpatialAttention(nn.Module):
    """Window MSA (reference net/MP_HSIR.py:158-218): qkv, the
    relative-position table (225, nH) and proj. Inside a PGSSTB the window
    kernel runs it with the block's LayerNorm; :meth:`forward` runs it alone
    on window tokens through the window MSA kernel (K14), as JAX's
    ``SpatialAttention(use_pallas=True)`` does."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.ws = window_size
        self.qkv = Linear(dim, dim * 3)
        table = torch.empty((2 * window_size - 1) ** 2, num_heads)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(table, std=0.02, a=-0.04, b=0.04))
        self.register_buffer("relative_position_index",
                             torch.as_tensor(relative_position_index(window_size).reshape(-1)),
                             persistent=False)
        self.proj = Linear(dim, dim)

    def rel_bias(self) -> torch.Tensor:
        n = self.ws * self.ws
        b = self.relative_position_bias_table[self.relative_position_index]
        return b.reshape(n, n, self.num_heads).permute(2, 0, 1).float().contiguous()

    def forward(self, windows: torch.Tensor, shift_labels=None) -> torch.Tensor:
        """windows (NW, 64, C) -> (NW, 64, C); ``shift_labels`` (nW_pattern,
        64) int region labels of a shifted block (tokens of different regions
        do not attend to each other), tiled over the windows, or None."""
        return window_msa(windows, self.qkv.weight, self.qkv.bias, self.rel_bias(),
                          self.proj.weight, self.proj.bias, self.num_heads, shift_labels)


class CrossAttention(nn.Module):
    """Channel cross attention, q from the text map, k/v from the visual
    prompt (reference net/MP_HSIR.py:220-249); plain, as in JAX."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = Conv2d(dim, dim, 1)
        self.q_dwconv = Conv2d(dim, dim, 3, groups=dim)
        self.kv = Conv2d(dim, dim * 2, 1)
        self.kv_dwconv = Conv2d(dim * 2, dim * 2, 3, groups=dim * 2)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = Conv2d(dim, dim, 1)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor, axis=None) -> torch.Tensor:
        """``axis``: the maps' rows are split over it; the depthwise convs
        exchange halo rows and the pixel sums add over the axis (JAX
        ``models/layers.py:745-770``)."""
        b, h, w, c = x_q.shape
        nh = self.num_heads
        dh = c // nh
        q = depthwise_conv2d(conv2d(x_q, self.q.weight), self.q_dwconv.weight, axis=axis)
        kv = depthwise_conv2d(conv2d(x_kv, self.kv.weight), self.kv_dwconv.weight, axis=axis)
        k, v = kv.chunk(2, dim=-1)
        q, k, v = (t.reshape(b, h * w, nh, dh) for t in (q, k, v))
        gram = psum(torch.einsum("bphd,bphe->bhde", q.float(), k.float()), axis)
        nq = psum(q.float().square().sum(dim=1), axis).sqrt().clamp_min(1e-12)
        nk = psum(k.float().square().sum(dim=1), axis).sqrt().clamp_min(1e-12)
        attn = gram / (nq[..., :, None] * nk[..., None, :])
        attn = torch.softmax(attn * self.temperature.float().reshape(1, nh, 1, 1), dim=-1).to(v.dtype)
        out = torch.einsum("bhde,bphe->bphd", attn, v).reshape(b, h, w, c)
        return self.project_out(out)


class CrossTransformer(nn.Module):
    """Cross attention + GDFN with pre-norms (reference net/MP_HSIR.py:267-287)."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66):
        super().__init__()
        self.attn = CrossAttention(dim, num_heads)
        self.norm11 = LayerNorm(dim)
        self.norm12 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.ffn = GDFN(dim, expansion)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor) -> torch.Tensor:
        x = x_q + self.attn(self.norm11(x_q), self.norm12(x_kv))
        return x + self.ffn(self.norm2(x))


class TransformerBlock(nn.Module):
    """MDTA + GDFN (reference net/MP_HSIR.py:466-479): norm1 + attention +
    residual through the spectral kernels, norm2 + GDFN + residual (and the
    optional exit 1x1 ``proj_w``) through the GDFN kernel. ``x2`` makes the
    input ``cat([x, x2], -1)`` without materialising it."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SpectralAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = GDFN(dim, expansion)

    def forward(self, x, x2=None, proj_w=None, axis=None, spectral=None):
        """``axis``: x (and x2) are row shards (JAX ``models/layers.py:
        842-848``); the port keeps its fusions there too: the spectral
        tiles take the halo rows of cat(x, x2) with the LayerNorm in-kernel,
        and the GDFN tile runs over the shard's extended rows. ``spectral``:
        the heads run head-parallel over that mesh axis where it divides
        them, on JAX's unfused route (x + attn(LN1(x)), then the GDFN kernel
        with its residual; no x2 / proj_w there)."""
        sa, f = self.attn, self.ffn

        def ffn(y):
            return gdfn(y, self.norm2.weight, self.norm2.bias, f.project_in.weight,
                        f.dwconv.weight, f.project_out.weight, residual=True, proj_w=proj_w)

        if divides(self.attn.num_heads, spectral):
            if x2 is not None or proj_w is not None:
                raise ValueError("the head-parallel TransformerBlock takes the concatenated "
                                 "input and no exit conv (PromptFusion's explicit route)")
            _count_path("transformer_tp")
            y = sa.tp(self.norm1(x), spectral, axis, shortcut=x)
            return _on_extended_rows(ffn, y, axis) if _sharded(axis) else ffn(y)
        if _sharded(axis):
            y = sa.sharded(x, axis, x2=x2, ln=self.norm1, residual=True)
            return _on_extended_rows(ffn, y, axis)
        comb = sa.comb(x, x2=x2, ln=self.norm1)
        y = spectral_apply(x, comb, sa.qkv.weight, sa.qkv_dwconv.weight, x2=x2,
                           ln_w=self.norm1.weight, ln_b=self.norm1.bias, residual=True)
        return ffn(y)


class Conv3x3(nn.Module):
    """Bias-free 3x3 conv weight (OIHW) run by the conv3 kernel."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(_uniform_(torch.empty(cout, cin, 3, 3), cin * 9))

    def forward(self, x, mode: str = "plain", res=None, axis=None):
        """``axis``: x is a row shard; the conv runs over it extended by a
        neighbour row on each inner side (eight rows, so that ``down``'s row
        pairs keep their parity), cropped by the mode's output scale."""
        if not _sharded(axis):
            return conv3(x, self.weight, mode, res)
        return _on_extended_rows(lambda t, r=None: conv3(t, self.weight, mode, r), x, axis,
                                 {"down": 0.5, "up": 2}.get(mode, 1), res)


class Downsample(nn.Module):
    """3x3 conv C -> C/2 + PixelUnshuffle(2) (reference net/MP_HSIR.py:432-440)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv = Conv3x3(n_feat, n_feat // 2)

    def forward(self, x, axis=None):
        return self.conv(x, "down", axis=axis)


class Upsample(nn.Module):
    """3x3 conv C -> 2C + PixelShuffle(2) (reference net/MP_HSIR.py:442-450)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv = Conv3x3(n_feat, n_feat * 2)

    def forward(self, x, axis=None):
        return self.conv(x, "up", axis=axis)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, embed_dim: int):
        super().__init__()
        self.proj = Conv3x3(cin, embed_dim)

    def forward(self, x, axis=None):
        return self.proj(x, axis=axis)


class TVSP(nn.Module):
    """Text-visual synergistic prompt (reference net/MP_HSIR.py:538-583).
    The text x CLIP product is per sample, as in the JAX package
    (PARITY.md section 2.1): identical to the reference at batch 1."""

    def __init__(self, task_classes: int, prompt_size: int, prompt_dim: int, out_dim: int,
                 clip_table: np.ndarray):
        super().__init__()
        self.task_classes = task_classes
        self.prompt_size = prompt_size
        d = prompt_dim
        with torch.no_grad():
            lin = Linear(clip_table.shape[1], d)
            text = lin(torch.as_tensor(clip_table, dtype=torch.float32))
        self.text_prompt_learnable = nn.Parameter(text.detach().clone())
        self.visual_prompt = nn.Parameter(torch.randn(prompt_size, prompt_size, d))
        self.cross_transformer = CrossTransformer(d, num_heads=2, expansion=2.66)
        self.conv_last = Conv3x3(d, out_dim)

    def forward(self, x, clip_prompt, prompt_weights, axis=None):
        """``axis``: x is a row shard; the prompt maps do not depend on the
        feature grid, so every shard computes them whole and takes its row
        block of the global resize (JAX ``models/layers.py:975-982``)."""
        b, h, w, _ = x.shape
        t = (prompt_weights.float() @ self.text_prompt_learnable.float()) / self.task_classes
        tp = t[:, None, None, :] * clip_prompt.float()[:, None, :, None]
        tp = resize_nearest(tp, self.prompt_size, self.prompt_size).to(x.dtype)
        vis = self.visual_prompt[None].expand(b, -1, -1, -1).to(x.dtype)
        prompts = self.cross_transformer(tp, vis)
        if _sharded(axis):
            n = axis_size(axis)
            out = resize_bilinear_row_block(prompts, h * n, w, axis_index(axis) * h, h)
        else:
            out = resize_bilinear(prompts, h, w, align_corners=False)
        return self.conv_last(out, axis=axis)


class PromptFusion(nn.Module):
    """concat -> TransformerBlock at 2*dim -> 1x1 conv back (reference
    net/MP_HSIR.py:587-599); the concat is read in-kernel and the exit conv
    rides the GDFN kernel's writeback."""

    def __init__(self, dim: int, out_dim: int, num_heads: int, expansion: float = 2.66):
        super().__init__()
        self.transformer = TransformerBlock(dim, num_heads, expansion)
        self.conv = Conv2d(dim, out_dim, 1)

    def forward(self, x, prompt, axis=None, spectral=None):
        """``spectral``: under the spectral mesh axis, where it divides the
        heads, the explicit composition on both routes (JAX fuses only
        without the axis, ``models/layers.py:1013-1029``)."""
        if self.training or divides(self.transformer.attn.num_heads, spectral):
            # the explicit composition, as JAX's training route does
            # (mp_hsir_tpu/models/layers.py:1027-1029); on a row shard the
            # transformer's spectral tiles take halo rows and its GDFN runs
            # over the extended rows (the 1x1 conv is per pixel)
            _count_path("prompt_fusion_train" if self.training else "prompt_fusion_tp")
            return self.conv(self.transformer(torch.cat([x, prompt], dim=-1), axis=axis,
                                              spectral=spectral))
        _count_path("prompt_fusion_kernels")
        return self.transformer(x, x2=prompt, proj_w=self.conv.weight, axis=axis)


class PGSSTB(nn.Module):
    """Prompt-guided spatial-spectral transformer block (reference
    net/MP_HSIR.py:601-723):

    1. window kernel: LN + (shifted) window MSA + proj -> sa (rolled frame)
       and the per-window means;
    2. PG gate on the means (plain, as in JAX);
    3. spectral stats kernel on sa read in the unrolled frame, fold;
    4. spectral apply kernel: shortcut + sa * gate + attn(sa), then (eval)
       the tail out + GatedMlp(LN2(out)), written in the unrolled frame.

    Training route (JAX ``layers.py:1113-1238``): step 4 scales the branch
    sum by the drop-path scale ``dp1`` and leaves out the tail; the MLP
    kernel then writes out + dp2 * GatedMlp(LN2(out)).
    """

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, compress_ratio: int, prompt_len: int,
                 input_resolution: Tuple[int, int] = (64, 64), drop_path: float = 0.0):
        super().__init__()
        ws, shift = window_size, shift_size
        # the reference freezes the window/shift decision at construction
        # from input_resolution (net/MP_HSIR.py:613-616)
        if min(input_resolution) <= ws:
            shift, ws = 0, min(input_resolution)
        self.ws, self.shift, self.num_heads = ws, shift, num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = SpatialAttention(dim, ws, num_heads)
        self.local_spectral_attn = PGSpectralAttention(dim, compress_ratio, prompt_len)
        self.gobal_spectral_attn = SpectralAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = GatedMlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def drop_path_scales(self, b: int, generator, device):
        """(dp1, dp2) for one training forward, drawn in JAX's order (branch
        sum, then MLP), or None when the rate is 0 (JAX draws none then)."""
        if self.drop_path.rate == 0.0:
            return None
        return (self.drop_path.scales(b, generator, device),
                self.drop_path.scales(b, generator, device))

    def forward(self, x: torch.Tensor, dp=None, axis=None, spectral=None) -> torch.Tensor:
        """``axis``: x is a row shard over the spatial mesh axis;
        ``spectral``: the spectral attention runs head-parallel over that
        mesh axis where it divides the heads."""
        b, h, w, c = x.shape
        if min(self.ws, h, w) != 8 or h % 8 or w % 8:
            raise ValueError(f"the window kernel takes 8x8 windows on H, W % 8 == 0; got "
                             f"ws={self.ws} map {(h, w)}")
        if divides(self.num_heads, spectral):
            return self._forward_sharded(x, axis, dp, spectral)
        if _sharded(axis):
            return self._forward_sharded(x, axis, dp)
        _count_path("pgsstb_kernels")
        shift = self.shift
        at = self.attn
        sa, pooled = window_attention(x, self.norm1.weight, self.norm1.bias, at.qkv.weight,
                                      at.qkv.bias, at.rel_bias(), at.proj.weight, at.proj.bias,
                                      self.num_heads, shift=shift)
        gate = self.local_spectral_attn(pooled.reshape(b, -1, c)).reshape(b, h // 8, w // 8, c)
        sp = self.gobal_spectral_attn
        comb = sp.comb(sa, shift=shift)
        m = self.mlp
        if self.training:
            dp1, dp2 = (None, None) if dp is None else dp
            y = spectral_apply(sa, comb, sp.qkv.weight, sp.qkv_dwconv.weight, shift=shift,
                               gate=gate, shortcut=x, dp_scale=dp1)
            return mlp(y, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                       m.fc2.weight, m.fc2.bias, residual=True, dp_scale=dp2)
        return spectral_apply(sa, comb, sp.qkv.weight, sp.qkv_dwconv.weight, shift=shift,
                              gate=gate, shortcut=x,
                              mlp=(self.norm2.weight, self.norm2.bias, m.fc1.weight,
                                   m.fc1.bias, m.fc2.weight, m.fc2.bias))


    def _forward_sharded(self, x: torch.Tensor, axis, dp=None, spectral=None) -> torch.Tensor:
        """Both routes on a row shard over ``axis`` (JAX's sharded epilogue,
        ``models/layers.py:1095-1250``): the (-shift, -shift) roll across the
        shards, the window tile with no roll of its own and the global map's
        region labels of this shard's rows, the PG gate, the roll back, then
        the sharded spectral attention with the gate and shortcut. A shifted
        block's gates ride back with it as a per-pixel map, the apply tile's
        gate operand as JAX's ``gate_map``: out = x + dp1 * (attn(sa) + sa *
        gate_map), rounded as on one device. Eval: the tail MLP in the apply
        tile; training: the
        branch scaled by the drop-path scale ``dp1`` and the MLP kernel
        after it with ``dp2``, as on one device. ``spectral``: JAX's TP
        epilogue (``models/layers.py:1122-1237``, on the whole map or a row
        shard): the attention head-parallel over that axis with the gate and
        drop-path in its apply and the shortcut after the sum, then the MLP
        kernel with its residual on both routes."""
        _count_path("pgsstb_kernels_sharded" if spectral is None else "pgsstb_kernels_tp")
        b, h, w, c = x.shape
        shift = self.shift
        region = None
        xr = x
        if shift:
            row0 = axis_index(axis) * h
            region = region_labels(h * axis_size(axis), w, shift, x.device)[row0:row0 + h]
            xr = roll_hw(x, -shift, -shift, axis)
        at = self.attn
        sa, pooled = window_attention(xr, self.norm1.weight, self.norm1.bias, at.qkv.weight,
                                      at.qkv.bias, at.rel_bias(), at.proj.weight, at.proj.bias,
                                      self.num_heads, region=region)
        gate = self.local_spectral_attn(pooled.reshape(b, -1, c)).reshape(b, h // 8, w // 8, c)
        m = self.mlp
        dp1, dp2 = (None, None) if dp is None else dp
        if self.training or spectral is not None:
            epilogue = dict(dp_scale=dp1)
        else:
            epilogue = dict(mlp=(self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                                 m.fc2.weight, m.fc2.bias))
        if shift:
            sa = roll_hw(sa, shift, shift, axis)
            gate = roll_hw(gate.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2),
                           shift, shift, axis)
        sp = self.gobal_spectral_attn
        if spectral is not None:
            y = sp.tp(sa, spectral, axis, gate=gate, shortcut=x, **epilogue)
        else:
            y = sp.sharded(sa, axis, gate=gate, shortcut=x, **epilogue)
        if not self.training and spectral is None:
            return y
        return mlp(y, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight,
                   m.fc2.bias, residual=True, dp_scale=dp2)


class BaseBlock(nn.Module):
    """``depth`` PGSSTBs with alternating shift and an outer residual
    (reference net/MP_HSIR.py:727-761)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, mlp_ratio: float,
                 compress_ratio: int, prompt_len: int,
                 input_resolution: Tuple[int, int] = (64, 64), drop_path=()):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", PGSSTB(
                dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                mlp_ratio, compress_ratio, prompt_len, input_resolution,
                float(drop_path[i]) if len(drop_path) else 0.0))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                axis=None, spectral=None) -> torch.Tensor:
        y = x
        for i in range(self.depth):
            blk = getattr(self, f"blocks_{i}")
            dp = blk.drop_path_scales(x.shape[0], generator, x.device) if self.training else None
            y = blk(y, dp, axis, spectral)
        return y + x
