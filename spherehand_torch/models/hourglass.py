"""Stacked hourglass heatmap CNN (NCHW).

Counterpart of ``spherehand_tpu/models/hourglass.py`` (reference
network/hourglass.py): pre-activation GroupNorm bottlenecks (expansion 2), a
recursive depth-2 U-shape with 2x2 max-pool down and bilinear x2 up, N stacks
with intermediate supervision re-injection, and 2*41-channel score maps per
stack. Module names mirror the flax ones, so ``convert.py`` maps each flax
key ``a/b/c`` onto ``a.b.c``.

Stem: 5x5 stride-2 conv (1->64) -> GN(4) -> three bottlenecks with a
max-pool after the first, leaving (B, 256, 16, 16) features for the stacks.

``dtype`` is the convolutions' compute dtype, as the flax ``dtype``
(hourglass.py:40-42 of the JAX package): under ``torch.bfloat16`` each
convolution casts its input, kernel and bias to bfloat16 and adds the bias
after the product, as flax does; GroupNorm takes its input in float32 (its
statistics and output are float32); the residuals, pools and the upsample
run in the convolutions' dtype; the heads and latents are upcast to float32
before anything reads them. Parameters stay float32. Only the network
changes dtype: soft-argmax, the losses and every geometry op downstream see
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _GroupNorm(nn.GroupNorm):
    """GroupNorm in float32 whatever its input's dtype (flax computes the
    statistics in at least float32 and returns the parameters' dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def _gn(channels: int, groups: int = 16) -> nn.GroupNorm:
    return _GroupNorm(groups, channels, eps=1e-5)


class _Conv(nn.Conv2d):
    """A convolution computed in ``compute_dtype`` (None: the parameters'
    float32, PyTorch's own path)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None or dt == self.weight.dtype:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return y + self.bias.to(dt)[:, None, None]


class Bottleneck(nn.Module):
    """Pre-activation GroupNorm bottleneck, expansion 2."""

    def __init__(self, in_ch: int, planes: int, downsample: bool = False):
        super().__init__()
        self.gn1 = _gn(in_ch)
        self.conv1 = _Conv(in_ch, planes, 1)
        self.gn2 = _gn(planes)
        self.conv2 = _Conv(planes, planes, 3, padding=1)
        self.gn3 = _gn(planes)
        self.conv3 = _Conv(planes, planes * 2, 1)
        self.down = _Conv(in_ch, planes * 2, 1) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.gn1(x)))
        y = self.conv2(F.relu(self.gn2(y)))
        y = self.conv3(F.relu(self.gn3(y)))
        return y + (self.down(x) if self.down is not None else x.to(y.dtype))


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


def _upsample2_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres (== jax.image.resize bilinear)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Hourglass(nn.Module):
    """Recursive U-module; returns (out, innermost latent)."""

    def __init__(self, planes: int = 128, depth: int = 2):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            for j in range(4 if i == 0 else 3):
                self.add_module(f"b{i}_{j}", Bottleneck(2 * planes, planes))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self._recurse(self.depth, x)

    def _recurse(self, n: int, x: torch.Tensor):
        block = lambda i, j: getattr(self, f"b{i}_{j}")  # noqa: E731
        up1 = block(n - 1, 0)(x)
        low1 = block(n - 1, 1)(_max_pool2(x))
        if n > 1:
            low2, latent = self._recurse(n - 1, low1)
        else:
            low2 = block(0, 3)(low1)
            latent = low2
        low3 = block(n - 1, 2)(low2)
        return up1 + _upsample2_bilinear(low3), latent


class HourglassNet(nn.Module):
    """N-stack hourglass emitting (B, num_outputs, 16, 16) scores per stack.

    ``forward`` returns (scores, latents): lists of per-stack score maps and
    innermost hourglass features. Channels [0:41] are uv heatmaps, [41:82]
    depth heatmaps.
    """

    def __init__(self, num_stacks: int = 2, num_outputs: int = 82, feats: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stacks = num_stacks
        ch = feats * 2
        self.conv1 = _Conv(1, 64, 5, stride=2, padding=2)
        self.gn1 = _gn(64, groups=4)
        self.layer1 = Bottleneck(64, 64, downsample=True)
        self.layer2 = Bottleneck(128, 128, downsample=True)
        self.layer3 = Bottleneck(256, feats)
        for i in range(num_stacks):
            self.add_module(f"hg{i}", Hourglass(feats))
            self.add_module(f"res{i}", Bottleneck(ch, feats))
            self.add_module(f"fc_conv{i}", _Conv(ch, ch, 1))
            self.add_module(f"fc_gn{i}", _gn(ch))
            self.add_module(f"score{i}", _Conv(ch, num_outputs, 1))
            if i < num_stacks - 1:
                self.add_module(f"inter_fc{i}", _Conv(ch, ch, 1))
                self.add_module(f"inter_score{i}", _Conv(num_outputs, ch, 1))
        self.set_dtype(dtype)

    def set_dtype(self, dtype: torch.dtype) -> None:
        """Set the convolutions' compute dtype (the parameters stay float32)."""
        self.dtype = dtype
        for module in self.modules():
            if isinstance(module, _Conv):
                module.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        if x.dim() == 3:
            x = x[:, None]  # (B, H, W) depth map -> single channel
        x = F.relu(self.gn1(self.conv1(x)))
        x = self.layer1(x)
        x = _max_pool2(x)
        x = self.layer3(self.layer2(x))

        scores, latents = [], []
        for i in range(self.num_stacks):
            m = lambda name: getattr(self, f"{name}{i}")  # noqa: E731
            y, latent = m("hg")(x)
            y = m("res")(y)
            y = F.relu(m("fc_gn")(m("fc_conv")(y)))
            score = m("score")(y)
            # heads and latents leave the network in float32
            scores.append(score.float())
            latents.append(latent.float())
            if i < self.num_stacks - 1:
                x = x + m("inter_fc")(y) + m("inter_score")(score)
        return scores, latents
