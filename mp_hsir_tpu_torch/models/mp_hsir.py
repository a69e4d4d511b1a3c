"""MP_HSIR_Net: 3-level prompt-guided U-Net transformer (counterpart of
``mp_hsir_tpu/models/mp_hsir.py``; behavioural contract reference
net/MP_HSIR.py:763-844).

Input cubes are ``(B, C, H, W)`` float32 in [0, 1] with integer task ids;
the model runs NHWC in ``cfg.compute_dtype`` and adds the global input
residual in float32. H and W must be multiples of 32. ``model.train()`` runs
the training route (JAX ``deterministic=False``: per-sample drop-path drawn
from the ``generator`` passed to ``forward``), ``model.eval()`` the eval one.
``forward(..., axis=...)`` runs either route on a row shard of the cube
(JAX's ``cfg.spatial_axis``, ``models/mp_hsir.py:41``): every layer takes
the spatial mesh axis, and the global input residual stays local to the
shard. Each shard's H must then be a multiple of 32. On the training route
every shard of one cube passes a generator in the same state, so that the
drop-path draws agree across its shards. ``forward(..., spectral=...)``
runs every spectral attention whose heads the spectral mesh axis divides
head-parallel over it (JAX's ``cfg.spectral_axis``): each member of the axis
passes the same input (or the same row shard) and gets the same output.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mp_hsir_tpu_torch import resolve_device
from mp_hsir_tpu_torch.config import ModelConfig
from mp_hsir_tpu_torch.models import layers as L
from mp_hsir_tpu_torch.models.text_prompts import (
    clip_prompt_embedding, clip_text_table, text_prompt_weights,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MPHSIRNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dim, nb, hd = cfg.dim, cfg.num_blocks, cfg.heads
        ws, cr = cfg.window_size, cfg.compress_ratios
        table = clip_text_table(cfg.task_classes)
        # per-block drop-path rates, as JAX (mp_hsir_tpu/models/mp_hsir.py:49-52,
        # the refinement reusing level 2's, cycled)
        dpr = np.linspace(0.0, cfg.drop_path_max, sum(nb))
        dp1, dp2, dp3 = dpr[:nb[0]], dpr[nb[0]:nb[0] + nb[1]], dpr[nb[0] + nb[1]:]
        dp_ref = [dp2[i % len(dp2)] for i in range(cfg.num_refinement_blocks)]

        def base_block(d, depth, heads, level_ws, ratio, level, dp):
            res = (cfg.train_resolution[0] >> level, cfg.train_resolution[1] >> level)
            return L.BaseBlock(d, depth, heads, level_ws, cfg.ffn_expansion_factor, ratio,
                               cfg.prompt_len, res, dp)

        self.patch_embed = L.OverlapPatchEmbed(cfg.in_channels, dim)
        self.encoder_level1 = base_block(dim, nb[0], hd[0], ws[0], cr[0], 0, dp1)
        self.down1_2 = L.Downsample(dim)
        self.encoder_level2 = base_block(dim * 2, nb[1], hd[1], ws[1], cr[1], 1, dp2)
        self.down2_3 = L.Downsample(dim * 2)
        self.latent = base_block(dim * 4, nb[2], hd[2], ws[2], cr[2], 2, dp3)
        self.up3_2 = L.Upsample(dim * 4)
        self.prompt2 = L.TVSP(cfg.task_classes, cfg.prompt_sizes[1], dim * 2, dim * 2, table)
        self.fusion2 = L.PromptFusion(dim * 4, dim * 2, num_heads=8)
        self.reduce_chan_level2 = L.Conv2d(dim * 4, dim * 2, 1)
        self.decoder_level2 = base_block(dim * 2, nb[1], hd[1], ws[1], cr[1], 1, dp2)
        self.up2_1 = L.Upsample(dim * 2)
        self.prompt1 = L.TVSP(cfg.task_classes, cfg.prompt_sizes[0], dim, dim, table)
        self.fusion1 = L.PromptFusion(dim * 2, dim, num_heads=4)
        self.decoder_level1 = base_block(dim * 2, nb[0], hd[0], ws[0], cr[0], 0, dp1)
        self.refinement = base_block(dim * 2, cfg.num_refinement_blocks, hd[0], ws[0], cr[0], 0,
                                     dp_ref)
        self.output = L.Conv3x3(dim * 2, cfg.out_channels)

    def forward(self, inp: torch.Tensor, task_id: torch.Tensor,
                generator: torch.Generator | None = None, axis=None,
                spectral=None) -> torch.Tensor:
        """``axis``: inp is this rank's row block of the cube, whose rows are
        split over the spatial mesh axis; returns the block's rows of the
        output. ``spectral``: the spectral mesh axis (head-parallel spectral
        attention; every member of it holds the same input and output)."""
        cfg = self.cfg
        if inp.ndim != 4:
            raise ValueError(f"expected (B, C, H, W), got {tuple(inp.shape)}")
        dt = DTYPES[cfg.compute_dtype]
        inp_nhwc = inp.float().permute(0, 2, 3, 1).contiguous()
        x = inp_nhwc.to(dt)
        prompt_weights = text_prompt_weights(task_id.to(inp.device), cfg.task_classes)
        clip_prompt = clip_prompt_embedding(prompt_weights, cfg.task_classes)
        dim = cfg.dim

        g, ax, tp = generator, axis, spectral
        enc1 = self.encoder_level1(self.patch_embed(x, ax), g, ax, tp)
        enc2 = self.encoder_level2(self.down1_2(enc1, ax), g, ax, tp)
        latent = self.latent(self.down2_3(enc2, ax), g, ax, tp)

        d2 = self.up3_2(latent, ax)
        p2 = self.prompt2(enc2, clip_prompt, prompt_weights, ax)
        enc2f = self.fusion2(enc2, p2, ax, tp)
        # concat + 1x1 reduce as split-weight products: cat([a, b]) @ W ==
        # a @ W_top + b @ W_bot (the concatenation is never built)
        w2d = self.reduce_chan_level2.weight.reshape(dim * 2, dim * 4).t().to(dt)
        d2 = d2 @ w2d[: dim * 2] + enc2f @ w2d[dim * 2:]
        dec2 = self.decoder_level2(d2, g, ax, tp)

        d1 = self.up2_1(dec2, ax)
        p1 = self.prompt1(enc1, clip_prompt, prompt_weights, ax)
        enc1f = self.fusion1(enc1, p1, ax, tp)
        dec1 = self.decoder_level1(torch.cat([d1, enc1f], dim=-1), g, ax, tp)
        ref = self.refinement(dec1, g, ax, tp)
        # output conv + the global float32 input residual in one writeback
        out = self.output(ref, "res", inp_nhwc, ax)
        return out.permute(0, 3, 1, 2)


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                train: bool = False) -> MPHSIRNet:
    """A model on ``device`` (default the card; raises without one), in eval
    mode unless ``train``."""
    return MPHSIRNet(cfg).to(resolve_device(device)).train(train)
