"""Feature networks for (E-)LPIPS: VGG16 variants and SqueezeNet 1.1.

Counterpart of `matryodshka_tpu/losses/elpips/networks.py` (the conv
towers of the reference's elpips/elpips/networks.py), as nn.Modules on
NCHW tuples of images:
  * VGG16 `full_avg` (:672-...): 13 convs, 2x2 average pooling, 14 taps
    (the raw input plus every conv activation): the E-LPIPS ensemble's;
  * VGG16 `lpips` (:469-...): the classic LPIPS 5 taps, with the JAX
    package's 3x3 stride-2 VALID max pooling;
  * SqueezeNet 1.1 `lpips` (:73-) / `full_maxpool` (:270-): fire
    modules; 7 and 10 taps.

Weights: {'<torch_idx>.weight': [Cout, Cin, KH, KW], '<torch_idx>.bias':
[Cout]} under the torchvision features indices the reference uses
(`weights.elpips_from_jax` maps the JAX package's HWIO arrays); the
weights are constants of the metric. Dropout (keep 0.99) multiplies every
image of the tuple by ONE shared mask per conv input, of the shape of one
image batch (networks.py:50-70); the caller's `dropout(like)` returns it.

The convs run in float32 with TF32 off on the card, forward and input
gradient, scoped to these calls (`ConvF32`); the pools and ReLUs are
PyTorch's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Images = Tuple[torch.Tensor, ...]
#: dropout(like) -> the mask shared by every image of the tuple at one
#: conv input, shaped like `like` (the tuple's first image).
Dropout = Optional[Callable[[torch.Tensor], torch.Tensor]]

# (torch_idx, in_ch, out_ch) of VGG16 features convs.
VGG16_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
# Channel counts of the 14 full_avg taps (input + 13 convs).
VGG16_FULL_AVG_CHANNELS = [3] + [c for (_, _, c) in VGG16_CONVS]
# Classic LPIPS taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
VGG16_LPIPS_CHANNELS = [64, 128, 256, 512, 512]

# (torch_idx, in, squeeze, expand1x1, expand3x3) of the fire modules.
SQUEEZE_FIRE = [
    (3, 64, 16, 64, 64), (4, 128, 16, 64, 64),
    (6, 128, 32, 128, 128), (7, 256, 32, 128, 128),
    (9, 256, 48, 192, 192), (10, 384, 48, 192, 192),
    (11, 384, 64, 256, 256), (12, 512, 64, 256, 256),
]
SQUEEZE_LPIPS_CHANNELS = [64, 128, 256, 384, 384, 512, 512]
SQUEEZE_FULL_MAXPOOL_CHANNELS = [3, 64, 128, 128, 256, 256, 384, 384,
                                 512, 512]


def random_vgg_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random VGG16 weights (He init), HWIO numpy arrays
    under the torchvision indices, drawn from np.random.RandomState(seed).

    The trained weights are not redistributable from this repo; this
    fallback keeps the full compute path runnable (NOT a calibrated
    perceptual metric)."""
    rng = np.random.RandomState(seed)
    w = {}
    for idx, cin, cout in VGG16_CONVS:
        std = np.sqrt(2.0 / (3 * 3 * cin))
        w[f"{idx}.weight"] = (rng.standard_normal((3, 3, cin, cout))
                              * std).astype(np.float32)
        w[f"{idx}.bias"] = np.zeros((cout,), np.float32)
    return w


def random_squeeze_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """SqueezeNet 1.1's counterpart of random_vgg_weights."""
    rng = np.random.RandomState(seed)
    w = {}

    def add(name, shape):
        std = np.sqrt(2.0 / max(int(np.prod(shape[:-1])), 1))
        w[name + ".weight"] = (rng.standard_normal(shape)
                               * std).astype(np.float32)
        w[name + ".bias"] = np.zeros((shape[-1],), np.float32)

    add("0", (3, 3, 3, 64))
    for idx, cin, s, e1, e3 in SQUEEZE_FIRE:
        add(f"{idx}.squeeze", (1, 1, cin, s))
        add(f"{idx}.expand1x1", (1, 1, s, e1))
        add(f"{idx}.expand3x3", (3, 3, s, e3))
    return w


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convs in full float32 inside the block (the flag is global
    state, so it is restored on the way out)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class ConvF32(torch.autograd.Function):
    """F.conv2d with TF32 off in the forward and in the backward, which
    autograd runs outside any caller's scope. The weights are constants:
    the backward returns the input gradient only."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride: int, padding: int):
        ctx.save_for_backward(weight)
        ctx.conf = (x.shape, stride, padding)
        with _no_tf32():
            return F.conv2d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        (weight,) = ctx.saved_tensors
        shape, stride, padding = ctx.conf
        with _no_tf32():
            gx = torch.nn.grad.conv2d_input(shape, weight, gy, stride,
                                            padding)
        return gx, None, None, None, None


class _Tower(nn.Module):
    """The weights as buffers ('.' -> '_' in their names)."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in weights.items():
            self.register_buffer(k.replace(".", "_"),
                                 torch.as_tensor(v, dtype=torch.float32))

    def _w(self, name: str):
        return (getattr(self, f"{name}_weight"),
                getattr(self, f"{name}_bias"))

    def _conv_relu(self, xs: Images, name: str, dropout: Dropout,
                   stride: int = 1) -> Images:
        """ReLU(conv + bias) of each image, SAME padding at stride 1 (VALID
        at stride 2), after the shared dropout mask."""
        if dropout is not None:
            mask = dropout(xs[0])
            xs = tuple(t * mask for t in xs)
        weight, bias = self._w(name)
        pad = weight.shape[-1] // 2 if stride == 1 else 0
        return tuple(torch.relu(ConvF32.apply(t, weight, bias, stride, pad))
                     for t in xs)


def _pool(xs: Images, kind: str) -> Images:
    """2x2/2 average or 3x3/2 max pooling, VALID (networks.py:85-95)."""
    if kind == "avg":
        return tuple(F.avg_pool2d(t, 2, 2) for t in xs)
    return tuple(F.max_pool2d(t, 3, 2) for t in xs)


class VGG16Features(_Tower):
    """VGG16 conv tower with selectable taps and pooling, on tuples of
    images so the same dropout mask applies to all of them."""

    def __init__(self, weights: Dict[str, torch.Tensor],
                 variant: str = "full_avg", use_dropout: bool = False,
                 keep_prob: float = 0.99):
        super().__init__(weights)
        self.variant = variant
        self.use_dropout = use_dropout
        self.keep_prob = keep_prob

    def forward(self, xs: Images, dropout: Dropout = None
                ) -> List[Images]:
        """xs: tuple of [N, 3, H, W]; returns the list of per-tap
        tuples."""
        full = self.variant == "full_avg"
        dropout = dropout if self.use_dropout else None
        taps: List[Images] = [xs] if full else []
        x, conv_i = xs, 0
        # VGG16 blocks of 2, 2, 3, 3, 3 convs, a pool between blocks
        for block, n_convs in enumerate((2, 2, 3, 3, 3)):
            if block > 0:
                x = _pool(x, "avg" if full else "max")
            for k in range(n_convs):
                idx = VGG16_CONVS[conv_i][0]
                conv_i += 1
                x = self._conv_relu(x, str(idx), dropout)
                if full or k == n_convs - 1:
                    taps.append(x)
        return taps

    @property
    def tap_channels(self) -> List[int]:
        return (VGG16_FULL_AVG_CHANNELS if self.variant == "full_avg"
                else VGG16_LPIPS_CHANNELS)


class SqueezeNetFeatures(_Tower):
    """SqueezeNet 1.1 tower (fire modules): variant 'lpips' taps conv1 and
    fires 4, 7, 9, 10, 11, 12 (7); 'full_maxpool' the input, conv1 and
    every fire (10) (networks.py:250-264 / :456-...)."""

    def __init__(self, weights: Dict[str, torch.Tensor],
                 variant: str = "lpips", use_dropout: bool = False,
                 keep_prob: float = 0.99):
        super().__init__(weights)
        self.variant = variant
        self.use_dropout = use_dropout
        self.keep_prob = keep_prob

    def _fire(self, x: Images, idx: int, dropout: Dropout) -> Images:
        s = self._conv_relu(x, f"{idx}_squeeze", dropout)
        mask = dropout(s[0]) if dropout is not None else None
        s = s if mask is None else tuple(t * mask for t in s)
        e1 = self._conv_relu(s, f"{idx}_expand1x1", None)
        e3 = self._conv_relu(s, f"{idx}_expand3x3", None)
        return tuple(torch.cat([a, b], dim=1) for a, b in zip(e1, e3))

    def forward(self, xs: Images, dropout: Dropout = None
                ) -> List[Images]:
        full = self.variant == "full_maxpool"
        dropout = dropout if self.use_dropout else None
        taps: List[Images] = [xs] if full else []
        x = self._conv_relu(xs, "0", dropout, stride=2)
        taps.append(x)
        for pool_first, fire_idxs in ((True, (3, 4)), (True, (6, 7)),
                                      (True, (9,)), (False, (10,)),
                                      (False, (11,)), (False, (12,))):
            if pool_first:
                x = _pool(x, "max")
            for idx in fire_idxs:
                x = self._fire(x, idx, dropout)
                if full:
                    taps.append(x)
            if not full:
                taps.append(x)
        return taps

    @property
    def tap_channels(self) -> List[int]:
        return (SQUEEZE_FULL_MAXPOOL_CHANNELS
                if self.variant == "full_maxpool"
                else SQUEEZE_LPIPS_CHANNELS)
