"""Public (E-)LPIPS API: configs + Metric.

Counterpart of `matryodshka_tpu/losses/elpips/api.py` (the reference's
elpips/elpips/__init__.py:7-76 and elpips.py:243-331) with an explicit
torch.Generator. Configs:
  * elpips_vgg(batch_size, n): full ensemble + net dropout p=0.99
  * lpips_vgg(batch_size): plain LPIPS, no transforms
  * elpips_squeeze_maxpool(batch_size, n)
  * lpips_squeeze(batch_size)

Weights: `weight_path` points to an .npz in the JAX package's layout,
'net/<key>' conv weights (HWIO) and 'lin/lin{i}.model.1.weight' arrays
(the JAX package's tools/import_elpips_weights.py writes one from the
reference .npy files plus a torchvision checkpoint). Without one,
deterministic random conv features keep the computation runnable, but the
metric is NOT the calibrated perceptual distance (warned, and
`Metric.calibrated` is False).

Eager torch evaluates the network at the drawn (scale, swap) only: the
JAX package's 16-branch lax.switch and its host-drawn program pool are
compile workarounds that have nothing to do here.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from matryodshka_tpu_torch.losses.elpips import networks, pnetlin, \
    transforms
from matryodshka_tpu_torch.weights import elpips_from_jax


@dataclasses.dataclass
class Config:
    metric: str = "vgg_ensemble"
    enable_dropout: bool = True
    dropout_keep_prob: float = 0.99
    enable_offset: bool = True
    offset_max: int = 7
    enable_flip: bool = True
    enable_swap: bool = True
    enable_color_permutation: bool = True
    enable_color_multiplication: bool = True
    color_multiplication_mode: str = "color"
    enable_scale: bool = True
    num_scales: int = 8
    batch_size: int = 1
    average_over: int = 1

    @property
    def scale_probabilities(self):
        return tuple(1.0 / float(i) ** 2
                     for i in range(1, self.num_scales + 1))

    @property
    def transforms_enabled(self) -> bool:
        """False only for the plain LPIPS configs, which feed the images
        to the network untransformed."""
        return (self.enable_scale or self.enable_flip or self.enable_swap
                or self.enable_color_permutation
                or self.enable_color_multiplication or self.enable_offset)


def elpips_vgg(batch_size: int = 1, n: int = 1) -> Config:
    return Config(metric="vgg_ensemble", batch_size=batch_size,
                  average_over=n)


def lpips_vgg(batch_size: int = 1) -> Config:
    return Config(metric="vgg", enable_dropout=False, enable_offset=False,
                  enable_flip=False, enable_swap=False,
                  enable_color_permutation=False,
                  enable_color_multiplication=False, enable_scale=False,
                  batch_size=batch_size)


def elpips_squeeze_maxpool(batch_size: int = 1, n: int = 1) -> Config:
    return Config(metric="squeeze_ensemble_maxpool", batch_size=batch_size,
                  average_over=n)


def lpips_squeeze(batch_size: int = 1) -> Config:
    cfg = lpips_vgg(batch_size)
    cfg.metric = "squeeze"
    return cfg


def get_config(name: str, batch_size: int = 1, n: int = 1) -> Config:
    return {"elpips_vgg": lambda: elpips_vgg(batch_size, n),
            "lpips_vgg": lambda: lpips_vgg(batch_size),
            "elpips_squeeze_maxpool":
                lambda: elpips_squeeze_maxpool(batch_size, n),
            "lpips_squeeze": lambda: lpips_squeeze(batch_size)}[name]()


#: metric name -> packaged calibrated LPIPS linear-weight file (vendored
#: from the elpips distribution's .npy blobs; loaded at the reference's
#: elpips/elpips/pnetlin.py:58-60).
_PACKAGED_LIN = {
    "vgg_ensemble": "vgg_full_avg_lin.npz",
    "vgg": "vgg_maxpool_lin.npz",
    "squeeze_ensemble_maxpool": "squeeze_full_maxpool_lin.npz",
    "squeeze": "squeeze_lin.npz",
}

#: metric name -> (feature tower, its variant).
_NETWORKS = {
    "vgg_ensemble": (networks.VGG16Features, "full_avg"),
    "vgg": (networks.VGG16Features, "lpips"),
    "squeeze_ensemble_maxpool": (networks.SqueezeNetFeatures,
                                 "full_maxpool"),
    "squeeze": (networks.SqueezeNetFeatures, "lpips"),
}


def packaged_lin_weights(metric: str):
    """Calibrated LPIPS linear weights shipped with this package."""
    path = os.path.join(os.path.dirname(__file__), "weights",
                        _PACKAGED_LIN[metric])
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def load_weights(weight_path: Optional[str], metric: str):
    """Returns (net_weights, lin_weights, calibrated): the conv weights as
    OIHW tensors (weights.elpips_from_jax), the linear weights as numpy.

      * explicit ``weight_path`` .npz: 'net/...' conv weights (HWIO) +
        'lin/...' linear weights (the packaged ones when it holds none);
        ``calibrated`` is True;
      * otherwise: the packaged CALIBRATED linear weights + deterministic
        random conv features (runnable, warned: the VGG/Squeeze conv
        blobs are not redistributable inside this repo); ``calibrated``
        is False, and every consumer surfaces that (eval JSON, training
        metrics), so random-feature scores are never compared with real
        LPIPS numbers.
    """
    if weight_path is not None:
        with np.load(weight_path) as blob:
            net = {k[4:]: blob[k] for k in blob.files if k.startswith("net/")}
            lin = {k[4:]: blob[k] for k in blob.files if k.startswith("lin/")}
        return (elpips_from_jax(net), lin or packaged_lin_weights(metric),
                True)
    warnings.warn(
        "elpips: no weight_path given — using packaged calibrated linear "
        "weights but DETERMINISTIC RANDOM conv features; the metric is "
        "runnable but not the calibrated perceptual distance.")
    net = (networks.random_vgg_weights(0) if metric in ("vgg", "vgg_ensemble")
           else networks.random_squeeze_weights(0))
    return elpips_from_jax(net), packaged_lin_weights(metric), False


_M32 = 0xFFFFFFFF


def hashed_uniform(seed: int, start: int, shape, device) -> torch.Tensor:
    """Uniform [0, 1) float32 numbers of `shape`: element k is a 32-bit
    integer hash of (seed, start + k) (the two-round xorshift-multiply
    mixer with multipliers 0x21F0AAAD and 0x735A2D97: below 2^31, so each
    product of a 32-bit value stays inside int64), so every device draws
    the same bits."""
    n = math.prod(shape)
    x = torch.arange(start, start + n, device=device, dtype=torch.int64)
    x = (x * 0x3C6EF35F + (seed & _M32)) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    x = x ^ (x >> 15)
    return ((x >> 8).float() * 2.0 ** -24).reshape(shape)


@dataclasses.dataclass
class Draw:
    """One draw of the ensemble: the transforms (evaluated at
    params.scale_level and params.swap_xy) and the dropout masks, one per
    conv input in the tower's order, each [N, C, H, W].

    A mask missing from `masks` is drawn from `seed` (hashed_uniform over
    one counter that runs through the masks in order, the same bits on
    every device) and appended; `masks` given from elsewhere (the JAX
    package's, in the tests) are replayed."""
    params: transforms.EnsembleParams
    seed: int = 0
    masks: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def dropout(self, keep_prob: float):
        """The network's dropout(like) -> mask for one evaluation."""
        used = itertools.count()
        start = [0]

        def mask(like: torch.Tensor) -> torch.Tensor:
            i = next(used)
            first, start[0] = start[0], start[0] + like.numel()
            if i < len(self.masks):
                m = self.masks[i]
                if m.shape != like.shape:
                    raise ValueError(f"dropout mask {i}: shape "
                                     f"{tuple(m.shape)}, the conv input's "
                                     f"{tuple(like.shape)}")
                return m.to(like.device)
            u = hashed_uniform(self.seed, first, like.shape, like.device)
            m = (u < keep_prob).float() / keep_prob
            self.masks.append(m)
            return m

        return mask


class Metric(nn.Module):
    """Perceptual distance metric (elpips.py:243-331).

    forward(image, reference, generator) is the mean of d(T(image),
    T(reference)) over `average_over` random transform draws; a tuple
    `image` evaluates several candidates under IDENTICAL transforms and
    dropout. The images are [N, H, W, 3] in [0, 1]; they are cast to
    float32 and laid out NCHW once, here. The metric computes in float32:
    on the card its convs (forward and input gradient) run with TF32 off,
    scoped to the metric's own calls (networks.ConvF32); the global
    setting is left as it is. Move it to the images' device with
    `.to(device)`."""

    def __init__(self, config: Config, weight_path: Optional[str] = None):
        super().__init__()
        self.config = config
        net_w, lin_w, self.calibrated = load_weights(weight_path,
                                                     config.metric)
        if config.metric not in _NETWORKS:
            raise ValueError(config.metric)
        tower, variant = _NETWORKS[config.metric]
        net = tower(net_w, variant, use_dropout=config.enable_dropout,
                    keep_prob=config.dropout_keep_prob)
        self.network = pnetlin.PNetLin(net, lin_w)

    def draw(self, batch_size: int, generator: torch.Generator,
             scale: Optional[int] = None,
             swap: Optional[bool] = None) -> Draw:
        """Sample one draw from a CPU generator; scale and swap, when
        given, replace the drawn ones."""
        cfg = self.config
        params = transforms.sample_ensemble(generator, batch_size,
                                            cfg.offset_max,
                                            cfg.scale_probabilities,
                                            static_scale=scale)
        if swap is not None:
            params = params._replace(swap_xy=int(swap))
        seed = int(torch.randint(0, 2 ** 31, (), generator=generator))
        return Draw(params, seed)

    def _one_draw(self, xs, draw: Draw) -> torch.Tensor:
        cfg = self.config
        if cfg.transforms_enabled:
            p = draw.params
            xs = tuple(transforms.apply_ensemble(
                x, p, p.scale_level, cfg.offset_max, cfg.enable_offset,
                cfg.enable_scale, swap=bool(p.swap_xy) and cfg.enable_swap)
                for x in xs)
        xs = tuple(2.0 * x - 1.0 for x in xs)
        dropout = (draw.dropout(cfg.dropout_keep_prob)
                   if cfg.enable_dropout else None)
        return torch.stack(self.network(xs[:-1], xs[-1], dropout))

    def forward(self, image, reference: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[Draw]] = None):
        """image: [N, H, W, 3] or a tuple thereof; reference: [N, H, W, 3].
        Returns [N] distances (or a tuple of them).

        generator: the CPU torch.Generator the `average_over` draws come
        from (torch's default generator when None). draws: the draws
        themselves, in place of sampling (one per term of the mean)."""
        if isinstance(image, list):
            raise TypeError("image must be a tensor or tuple of tensors")
        images = image if isinstance(image, tuple) else (image,)
        xs = tuple(x.float().permute(0, 3, 1, 2)
                   for x in images + (reference,))
        if draws is None:
            g = torch.default_generator if generator is None else generator
            draws = [self.draw(reference.shape[0], g)
                     for _ in range(self.config.average_over)]
        total = sum(self._one_draw(xs, d) for d in draws) / len(draws)
        if isinstance(image, tuple):
            return tuple(total[i] for i in range(len(images)))
        return total[0]
