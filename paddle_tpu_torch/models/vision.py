"""The vision model zoo (port of paddle_tpu/models/vision.py): `MLP`,
`LeNet`, `AlexNet`, `VGG` / `vgg16`, `ResNet` / `resnet50`,
`SEResNeXt` / `se_resnext50` and `GoogLeNet`, over NHWC images.

Module names are JAX's, its Python lists becoming `nn.ModuleList`s
(`blocks.3.a.conv.weight` is JAX's `blocks_3/a/conv/weight`), so
`load_jax_params` copies a JAX tree, BatchNorm `state` included. The
port makes every parameter in `__init__`: where JAX infers a Linear's
input width from the flattened image (`MLP`, `LeNet`, `AlexNet`,
`VGG`), the constructor takes the input's (H, W, C) as `in_shape`,
defaulting to the shape JAX's tests and benchmark specs use; `ResNet`,
`SEResNeXt` and `GoogLeNet` end in a global pool and take only the
input's channels. The SE block's two Linears, which JAX makes on first
use, are made from the block's known width, under the same names.

`dtype` is the compute dtype (parameters stay float32). Models default
to the CUDA card (`device.resolve_device`) and start in eval mode;
`Dropout` draws from the `generator` that `forward` takes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dropout, Linear,
                                        global_avg_pool2d, max_pool2d)
from paddle_tpu_torch.ops import functional as F

MNIST_SHAPE = (28, 28, 1)
IMAGENET_SHAPE = (224, 224, 3)


def _pooled(n: int, window: int, stride: int) -> int:
    """A VALID pool's output size."""
    return (n - window) // stride + 1


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


class MLP(nn.Module):
    """mnist MLP: ReLU Linears of widths `hidden`, then the head."""

    def __init__(self, hidden: Sequence[int] = (128, 64),
                 num_classes: int = 10, in_shape=MNIST_SHAPE,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        widths = [in_shape[0] * in_shape[1] * in_shape[2], *hidden]
        self.fcs = nn.ModuleList(
            Linear(a, b, dtype=dtype, device=device)
            for a, b in zip(widths, widths[1:]))
        self.head = Linear(widths[-1], num_classes, dtype=dtype,
                           device=device)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.head(x)


class LeNet(nn.Module):
    """LeNet-5-style MNIST conv net: (conv 5 VALID, ReLU, max pool 2) x 2,
    then two Linears."""

    def __init__(self, num_classes: int = 10, in_shape=MNIST_SHAPE,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        h, w, c = in_shape
        kw = dict(padding="VALID", dtype=dtype, device=device)
        self.conv1 = Conv2D(c, 20, 5, **kw)
        self.conv2 = Conv2D(20, 50, 5, **kw)
        for _ in range(2):
            h, w = _pooled(h - 4, 2, 2), _pooled(w - 4, 2, 2)
        self.fc1 = Linear(h * w * 50, 500, dtype=dtype, device=device)
        self.fc2 = Linear(500, num_classes, dtype=dtype, device=device)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.reshape(x.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))


class AlexNet(nn.Module):
    """AlexNet: five convs (11/4, 5, 3, 3, 3) with three 3/2 max pools,
    then two dropout-4096 Linears and the head."""

    def __init__(self, num_classes: int = 1000, in_shape=IMAGENET_SHAPE,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        h, w, c = in_shape
        kw = dict(dtype=dtype, device=device)
        self.c1 = Conv2D(c, 64, 11, stride=4, padding=2, **kw)
        self.c2 = Conv2D(64, 192, 5, padding=2, **kw)
        self.c3 = Conv2D(192, 384, 3, padding=1, **kw)
        self.c4 = Conv2D(384, 256, 3, padding=1, **kw)
        self.c5 = Conv2D(256, 256, 3, padding=1, **kw)
        for k, s, p, pool in ((11, 4, 2, True), (5, 1, 2, True),
                              (3, 1, 1, False), (3, 1, 1, False),
                              (3, 1, 1, True)):
            h, w = _conv_out(h, k, s, p), _conv_out(w, k, s, p)
            if pool:
                h, w = _pooled(h, 3, 2), _pooled(w, 3, 2)
        self.fc1 = Linear(h * w * 256, 4096, **kw)
        self.fc2 = Linear(4096, 4096, **kw)
        self.head = Linear(4096, num_classes, **kw)
        self.drop = Dropout(0.5)
        self.eval()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = max_pool2d(F.relu(self.c1(x)), 3, 2)
        x = max_pool2d(F.relu(self.c2(x)), 3, 2)
        x = F.relu(self.c3(x))
        x = F.relu(self.c4(x))
        x = max_pool2d(F.relu(self.c5(x)), 3, 2)
        x = x.reshape(x.shape[0], -1)
        x = self.drop(F.relu(self.fc1(x)), generator)
        x = self.drop(F.relu(self.fc2(x)), generator)
        return self.head(x)


_VGG_CFG = {
    11: (1, 1, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


class VGG(nn.Module):
    """VGG-N with BatchNorm: five stages of 3x3 conv + BN + ReLU, each
    ending in a 2/2 max pool, then two dropout-512 Linears and the
    head."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 in_shape=IMAGENET_SHAPE, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        h, w, c = in_shape
        widths = (64, 128, 256, 512, 512)
        convs, bns = [], []
        self.plan = []
        for reps, width in zip(_VGG_CFG[depth], widths):
            for _ in range(reps):
                convs.append(Conv2D(c, width, 3, padding=1, use_bias=False,
                                    dtype=dtype, device=device))
                bns.append(BatchNorm(width, device=device))
                c = width
            self.plan.append(reps)
            h, w = _pooled(h, 2, 2), _pooled(w, 2, 2)
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Linear(h * w * 512, 512, **kw)
        self.fc2 = Linear(512, 512, **kw)
        self.head = Linear(512, num_classes, **kw)
        self.drop = Dropout(0.5)
        self.eval()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        i = 0
        for reps in self.plan:
            for _ in range(reps):
                x = F.relu(self.bns[i](self.convs[i](x)))
                i += 1
            x = max_pool2d(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        x = self.drop(F.relu(self.fc1(x)), generator)
        x = self.drop(F.relu(self.fc2(x)), generator)
        return self.head(x)


def vgg16(num_classes: int = 1000, **kw) -> VGG:
    return VGG(16, num_classes, **kw)


class _ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + an optional activation."""

    def __init__(self, in_features: int, features: int, kernel, stride=1,
                 padding="SAME", groups: int = 1,
                 act: Optional[Callable] = F.relu,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv2D(in_features, features, kernel, stride=stride,
                           padding=padding, groups=groups, use_bias=False,
                           dtype=dtype, device=device)
        self.bn = BatchNorm(features, device=device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class _Bottleneck(nn.Module):
    """ResNet bottleneck: 1x1, 3x3 (strided), 1x1 x4, and the projected
    shortcut on a stage's first block."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.a = _ConvBN(in_features, features, 1, **kw)
        self.b = _ConvBN(features, features, 3, stride=stride, **kw)
        self.c = _ConvBN(features, features * 4, 1, act=None, **kw)
        self.downsample = (_ConvBN(in_features, features * 4, 1,
                                   stride=stride, act=None, **kw)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c(self.b(self.a(x)))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet-{50,101,152}: a 7x7/2 stem (or, with `s2d_stem`, a 4x4/1
    conv over the 2x2 space-to-depth input, which needs even H and W),
    a 3/2 SAME max pool, bottleneck stages of widths 64-512 (x4), a
    global average pool and the head."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 s2d_stem: bool = False, in_channels: int = 3,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.s2d_stem = s2d_stem
        kw = dict(dtype=dtype, device=device)
        if s2d_stem:
            self.stem = _ConvBN(4 * in_channels, 64, 4, stride=1, **kw)
        else:
            self.stem = _ConvBN(in_channels, 64, 7, stride=2, **kw)
        blocks = []
        width = 64
        for stage, reps in enumerate(layers):
            features = 64 * (2 ** stage)
            for i in range(reps):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(_Bottleneck(width, features, stride=stride,
                                          downsample=(i == 0), **kw))
                width = features * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = Linear(width, num_classes, **kw)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.s2d_stem:
            from paddle_tpu_torch.ops.extras import space_to_depth
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(
                    f"s2d_stem requires even input H/W, got "
                    f"{tuple(x.shape[1:3])}")
            x = space_to_depth(x, 2)
        x = max_pool2d(self.stem(x), 3, 2, padding="SAME")
        for block in self.blocks:
            x = block(x)
        return self.head(global_avg_pool2d(x))


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, **kw)


class _SEBlock(nn.Module):
    """Squeeze-excite over `channels`: global pool, ReLU Linear to
    max(C / reduction, 4), sigmoid Linear back, channel-wise scale."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        mid = max(channels // reduction, 4)
        self.fc1 = Linear(channels, mid, dtype=dtype, device=device)
        self.fc2 = Linear(mid, channels, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(global_avg_pool2d(x)))
        s = F.sigmoid(self.fc2(s))
        return x * s[:, None, None, :]


class _SEResNeXtBlock(nn.Module):
    def __init__(self, in_features: int, features: int,
                 cardinality: int = 32, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.a = _ConvBN(in_features, features, 1, **kw)
        self.b = _ConvBN(features, features, 3, stride=stride,
                         groups=cardinality, **kw)
        self.c = _ConvBN(features, features * 2, 1, act=None, **kw)
        self.se = _SEBlock(features * 2, **kw)
        self.downsample = (_ConvBN(in_features, features * 2, 1,
                                   stride=stride, act=None, **kw)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.se(self.c(self.b(self.a(x))))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(y + identity)


class SEResNeXt(nn.Module):
    """SE-ResNeXt-50 32x4d: ResNet's stem and pools, grouped-conv blocks
    of widths 128-1024 (x2) with squeeze-excite."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 cardinality: int = 32, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        kw = dict(dtype=dtype, device=device)
        self.stem = _ConvBN(in_channels, 64, 7, stride=2, **kw)
        blocks = []
        width = 64
        for stage, reps in enumerate(layers):
            features = 128 * (2 ** stage)
            for i in range(reps):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(_SEResNeXtBlock(
                    width, features, cardinality, stride=stride,
                    downsample=(i == 0), **kw))
                width = features * 2
        self.blocks = nn.ModuleList(blocks)
        self.head = Linear(width, num_classes, **kw)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool2d(self.stem(x), 3, 2, padding="SAME")
        for block in self.blocks:
            x = block(x)
        return self.head(global_avg_pool2d(x))


def se_resnext50(num_classes: int = 1000, **kw) -> SEResNeXt:
    return SEResNeXt((3, 4, 6, 3), 32, num_classes, **kw)


class _Inception(nn.Module):
    """GoogLeNet inception block: 1x1 | 1x1-3x3 | 1x1-5x5 | 3/1 max pool
    -1x1, concatenated on channels."""

    def __init__(self, in_features: int, c1, c3r, c3, c5r, c5, proj,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.b1 = _ConvBN(in_features, c1, 1, **kw)
        self.b3a = _ConvBN(in_features, c3r, 1, **kw)
        self.b3b = _ConvBN(c3r, c3, 3, **kw)
        self.b5a = _ConvBN(in_features, c5r, 1, **kw)
        self.b5b = _ConvBN(c5r, c5, 5, **kw)
        self.proj = _ConvBN(in_features, proj, 1, **kw)
        self.features = c1 + c3 + c5 + proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.b1(x)
        p2 = self.b3b(self.b3a(x))
        p3 = self.b5b(self.b5a(x))
        p4 = self.proj(max_pool2d(x, 3, 1, padding="SAME"))
        return torch.cat([p1, p2, p3, p4], dim=-1)


_INCEPTIONS = (("i3a", (64, 96, 128, 16, 32, 32)),
               ("i3b", (128, 128, 192, 32, 96, 64)),
               ("i4a", (192, 96, 208, 16, 48, 64)),
               ("i4b", (160, 112, 224, 24, 64, 64)),
               ("i4c", (128, 128, 256, 24, 64, 64)),
               ("i4d", (112, 144, 288, 32, 64, 64)),
               ("i4e", (256, 160, 320, 32, 128, 128)),
               ("i5a", (256, 160, 320, 32, 128, 128)),
               ("i5b", (384, 192, 384, 48, 128, 128)))


class GoogLeNet(nn.Module):
    """GoogLeNet (Inception v1 with BatchNorm): a three-conv stem, nine
    inception blocks between SAME 3/2 max pools, a global pool, dropout
    0.4 and the head."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        kw = dict(dtype=dtype, device=device)
        self.stem1 = _ConvBN(in_channels, 64, 7, stride=2, **kw)
        self.stem2 = _ConvBN(64, 64, 1, **kw)
        self.stem3 = _ConvBN(64, 192, 3, **kw)
        width = 192
        for name, widths in _INCEPTIONS:
            block = _Inception(width, *widths, **kw)
            setattr(self, name, block)
            width = block.features
        self.head = Linear(width, num_classes, **kw)
        self.drop = Dropout(0.4)
        self.eval()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = max_pool2d(self.stem1(x), 3, 2, padding="SAME")
        x = max_pool2d(self.stem3(self.stem2(x)), 3, 2, padding="SAME")
        x = self.i3b(self.i3a(x))
        x = max_pool2d(x, 3, 2, padding="SAME")
        for name in ("i4a", "i4b", "i4c", "i4d", "i4e"):
            x = getattr(self, name)(x)
        x = max_pool2d(x, 3, 2, padding="SAME")
        x = self.i5b(self.i5a(x))
        x = self.drop(global_avg_pool2d(x), generator)
        return self.head(x)
