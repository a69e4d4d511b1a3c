"""Degradation classifier, eval route: the Fast-Fourier-Convolution ResNet
of ``mp_hsir_tpu/models/classifier.py`` (reference net/classifier.py:112-507,
itself from pkumivision/FFC) in NCHW.

It predicts a multi-label degradation vector for a cube whose degradation is
unknown; its argmax is the ``task_id`` prompt routed into MPHSIRNet
(``--auto_task``). BatchNorm runs from its running statistics; training,
SyncBN and the backbone classifier wait for the classifier-training slice.
Where the JAX module differs from the reference, this follows the JAX
module: the Fourier unit's 1x1 conv sees ``[real | imag]`` concatenated
along channels, LFU tiles the four quadrants of a quarter of the channels
into channels, and the stem's max pool pads with -inf. The convolutions,
FFTs and norms are plain PyTorch (no ``pallas_call`` computes them in JAX).
Absent local or global streams are ``None`` (JAX uses the float 0.0).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mp_hsir_tpu_torch.ops.resize import resize_bilinear


class _BN(nn.Module):
    """flax ``BatchNorm`` (eps 1e-5) from its running statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-5)


def _conv(cin: int, cout: int, kernel: int = 1, stride: int = 1, padding: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=bias)


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """a + b with None as an absent stream (JAX's 0.0)."""
    if a is None:
        return b
    return a if b is None else a + b


class FourierUnit(nn.Module):
    """rfft2 -> 1x1 conv on [real | imag] -> BN + ReLU -> irfft2, both
    transforms orthonormal (reference classifier.py:145-198)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_layer = _conv(2 * in_channels, 2 * out_channels)
        self.bn = _BN(2 * out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        f = torch.fft.rfftn(x.float(), s=(h, w), dim=(-2, -1), norm="ortho")
        y = F.relu(self.bn(self.conv_layer(torch.cat([f.real, f.imag], dim=1))))
        re, im = y.chunk(2, dim=1)
        out = torch.fft.irfftn(torch.complex(re, im), s=(h, w), dim=(-2, -1), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    """conv1x1 + BN + ReLU -> FourierUnit (+ the local unit over a 2x2 split)
    -> conv1x1 (reference classifier.py:210-258)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 enable_lfu: bool = True):
        super().__init__()
        half = out_channels // 2
        self.stride = stride
        self.enable_lfu = enable_lfu
        self.conv1 = _conv(in_channels, half)
        self.bn1 = _BN(half)
        self.fu = FourierUnit(half, half)
        if enable_lfu:
            self.lfu = FourierUnit(4 * (half // 4), half)
        self.conv2 = _conv(half, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = F.avg_pool2d(x, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        y = x + self.fu(x)
        if self.enable_lfu:
            # a quarter of the channels, the four spatial quadrants tiled into
            # channels (top-left, bottom-left, top-right, bottom-right)
            xs = x[:, : x.shape[1] // 4]
            xs = torch.cat(xs.chunk(2, dim=2), dim=1)
            xs = torch.cat(xs.chunk(2, dim=3), dim=1)
            y = y + self.lfu(xs).repeat(1, 1, 2, 2)
        return self.conv2(y)


class FFC(nn.Module):
    """Local and global streams with four cross paths (reference
    classifier.py:260-302)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, ratio_gin: float,
                 ratio_gout: float, stride: int = 1, padding: int = 0, enable_lfu: bool = True):
        super().__init__()
        in_cg = int(in_channels * ratio_gin)
        in_cl = in_channels - in_cg
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg

        def conv(cin, cout):
            return _conv(cin, cout, kernel, stride, padding)

        self.convl2l = conv(in_cl, out_cl) if out_cl > 0 and in_cl > 0 else None
        self.convg2l = conv(in_cg, out_cl) if out_cl > 0 and in_cg > 0 else None
        self.convl2g = conv(in_cl, out_cg) if out_cg > 0 and in_cl > 0 else None
        self.convg2g = (SpectralTransform(in_cg, out_cg, stride, enable_lfu)
                        if out_cg > 0 and in_cg > 0 else None)

    def forward(self, x_l, x_g):
        out_l = out_g = None
        if self.convl2l is not None:
            out_l = self.convl2l(x_l)
        if self.convg2l is not None:
            out_l = _add(out_l, self.convg2l(x_g))
        if self.convl2g is not None:
            out_g = self.convl2g(x_l)
        if self.convg2g is not None:
            out_g = _add(out_g, self.convg2g(x_g))
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int, ratio_gin: float,
                 ratio_gout: float, stride: int = 1, padding: int = 0, act: bool = False,
                 enable_lfu: bool = True):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel, ratio_gin, ratio_gout, stride, padding,
                       enable_lfu)
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg
        self.bn_l = _BN(out_cl) if out_cl > 0 else None
        self.bn_g = _BN(out_cg) if out_cg > 0 else None
        self.act = act

    def forward(self, x_l, x_g):
        y_l, y_g = self.ffc(x_l, x_g)
        if self.bn_l is not None:
            y_l = self.bn_l(y_l)
            if self.act:
                y_l = F.relu(y_l)
        if self.bn_g is not None:
            y_g = self.bn_g(y_g)
            if self.act:
                y_g = F.relu(y_g)
        return y_l, y_g


class FFCSEBlock(nn.Module):
    """Squeeze-excitation over the concatenated streams with one excitation
    conv per stream (reference classifier.py:112-142)."""

    def __init__(self, channels: int, ratio_g: float):
        super().__init__()
        in_cg = int(channels * ratio_g)
        in_cl = channels - in_cg
        self.conv1 = _conv(channels, channels // 16, bias=True)
        self.conv_a2l = _conv(channels // 16, in_cl, bias=True) if in_cl > 0 else None
        self.conv_a2g = _conv(channels // 16, in_cg, bias=True) if in_cg > 0 else None

    def forward(self, x_l, x_g):
        cat = x_l if x_g is None else torch.cat([x_l, x_g], dim=1)
        z = F.relu(self.conv1(cat.mean(dim=(2, 3), keepdim=True)))
        out_l = None if self.conv_a2l is None else x_l * torch.sigmoid(self.conv_a2l(z))
        out_g = None if self.conv_a2g is None else x_g * torch.sigmoid(self.conv_a2g(z))
        return out_l, out_g


class FFCBasicBlock(nn.Module):
    """Residual FFC block (reference classifier.py:335-374)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, ratio_gin: float = 0.5,
                 ratio_gout: float = 0.5, has_downsample: bool = False, enable_lfu: bool = True,
                 use_se: bool = False):
        super().__init__()
        self.downsample = (FFC_BN_ACT(inplanes, planes, 1, ratio_gin, ratio_gout, stride=stride,
                                      enable_lfu=enable_lfu) if has_downsample else None)
        self.conv1 = FFC_BN_ACT(inplanes, planes, 3, ratio_gin, ratio_gout, stride=stride,
                                padding=1, act=True, enable_lfu=enable_lfu)
        self.conv2 = FFC_BN_ACT(planes, planes, 3, ratio_gout, ratio_gout, padding=1,
                                enable_lfu=enable_lfu)
        self.se_block = FFCSEBlock(planes, ratio_gout) if use_se else None

    def forward(self, x_l, x_g):
        id_l, id_g = (x_l, x_g) if self.downsample is None else self.downsample(x_l, x_g)
        y_l, y_g = self.conv2(*self.conv1(x_l, x_g))
        if self.se_block is not None:
            y_l, y_g = self.se_block(y_l, y_g)
        out_g = _add(y_g, id_g)
        return F.relu(_add(y_l, id_l)), None if out_g is None else F.relu(out_g)


class FFCBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4 FFC bottleneck (reference
    classifier.py:377-413)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, ratio_gin: float = 0.5,
                 ratio_gout: float = 0.5, has_downsample: bool = False, enable_lfu: bool = True,
                 use_se: bool = False):
        super().__init__()
        out_planes = planes * self.expansion
        self.downsample = (FFC_BN_ACT(inplanes, out_planes, 1, ratio_gin, ratio_gout,
                                      stride=stride, enable_lfu=enable_lfu)
                           if has_downsample else None)
        self.conv1 = FFC_BN_ACT(inplanes, planes, 1, ratio_gin, ratio_gout, act=True,
                                enable_lfu=enable_lfu)
        self.conv2 = FFC_BN_ACT(planes, planes, 3, ratio_gout, ratio_gout, stride=stride,
                                padding=1, act=True, enable_lfu=enable_lfu)
        self.conv3 = FFC_BN_ACT(planes, out_planes, 1, ratio_gout, ratio_gout,
                                enable_lfu=enable_lfu)
        self.se_block = FFCSEBlock(out_planes, ratio_gout) if use_se else None

    def forward(self, x_l, x_g):
        id_l, id_g = (x_l, x_g) if self.downsample is None else self.downsample(x_l, x_g)
        y_l, y_g = self.conv3(*self.conv2(*self.conv1(x_l, x_g)))
        if self.se_block is not None:
            y_l, y_g = self.se_block(y_l, y_g)
        out_g = _add(y_g, id_g)
        return F.relu(_add(y_l, id_l)), None if out_g is None else F.relu(out_g)


class FFCResNet(nn.Module):
    """ResNet18-shaped FFC classifier (reference classifier.py:416-507).

    Input (B, C, H, W) in [0, 1], resized bilinearly to ``size``; returns
    multi-label logits (B, num_classes): 5 collapsed classes for natural
    scenes, 6 for remote sensing (reference utils/dataset_utils.py:173-185)."""

    def __init__(self, in_channel: int = 31, layers: Sequence[int] = (2, 2, 2, 2),
                 inplanes: int = 64, num_classes: int = 5, size: Tuple[int, int] = (256, 256),
                 ratio: float = 0.5, enable_lfu: bool = True, block: str = "basic",
                 use_se: bool = False):
        super().__init__()
        self.size = tuple(size)
        self.conv1 = _conv(in_channel, inplanes, 7, stride=2, padding=3)
        self.bn1 = _BN(inplanes)
        block_cls = FFCBasicBlock if block == "basic" else FFCBottleneck
        specs = [(inplanes, 1, 0.0, ratio), (inplanes * 2, 2, ratio, ratio),
                 (inplanes * 4, 2, ratio, ratio), (inplanes * 8, 2, ratio, 0.0)]
        self.blocks = []
        cin = inplanes
        for li, (planes, stride, rgin, rgout) in enumerate(specs):
            for bi in range(layers[li]):
                name = f"layer{li + 1}_{bi}"
                if bi == 0:
                    has_ds = stride != 1 or cin != planes * block_cls.expansion or rgin == 0
                    blk = block_cls(cin, planes, stride, rgin, rgout, has_ds, enable_lfu, use_se)
                    cin = planes * block_cls.expansion
                else:
                    blk = block_cls(cin, planes, 1, rgout, rgout, False, enable_lfu, use_se)
                self.add_module(name, blk)
                self.blocks.append(name)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x.permute(0, 2, 3, 1), *self.size).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x_l, x_g = F.max_pool2d(x, 3, stride=2, padding=1), None  # pads with -inf
        for name in self.blocks:
            x_l, x_g = getattr(self, name)(x_l, x_g)
        return self.fc(x_l.mean(dim=(2, 3)))


def degradation_label(de_index: int, num_classes: int = 5) -> np.ndarray:
    """Collapsed multi-label target of the classifier's de_type index
    (reference utils/dataset_utils.py:173-185)."""
    label = np.zeros(num_classes, np.float32)
    if de_index == 0:
        label[0] = 1
    elif de_index in (1, 2, 3):
        label[1] = 1
    elif de_index > 3:
        label[de_index - 2] = 1
    return label


def predicted_task_id(logits: torch.Tensor) -> torch.Tensor:
    """The routed task id: the collapsed class argmax (gaussian 0, complex 1,
    blur 2, sr 3, inpaint 4, [haze 5])."""
    return logits.argmax(dim=-1)
