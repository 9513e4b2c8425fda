"""Image quality metrics: SSIM, PSNR, temporal-consistency diffs.

Counterpart of `matryodshka_tpu/evaluation/metrics.py` (the reference's
eval surface, eval.py:127-145: tf.image.ssim, tf.image.psnr, elpips;
:147-188 frame-to-frame blurred diffs), on [H, W, C] tensors on any
device. SSIM follows tf.image.ssim's construction: 11x11 Gaussian window
with sigma=1.5, k1=0.01, k2=0.03, VALID separable filtering per channel,
then the mean. The filters are F.conv2d in float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from matryodshka_tpu_torch.losses.elpips.networks import ConvF32


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None
                     ) -> torch.Tensor:
    """The normalized 1-D Gaussian, built on the host in float32 with
    correctly rounded exponentials: the JAX package's kernel bit for bit,
    on every device. (SSIM on quantized images moves by ~1e-5 when one
    tap moves by one ulp.)"""
    x = np.arange(size, dtype=np.float32) - np.float32((size - 1) / 2.0)
    arg = np.float32(-0.5) * np.square(x / np.float32(sigma))
    g = np.exp(arg.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(g / g.sum(dtype=np.float32)).to(device)


def _filter2d_separable(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID separable filtering of [H, W, C] with the 1-D kernel k, down
    the rows then along them."""
    x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W], channels as batch
    x = ConvF32.apply(x, k.view(1, 1, -1, 1), None, 1, 0)
    x = ConvF32.apply(x, k.view(1, 1, 1, -1), None, 1, 0)
    return x[:, 0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """SSIM of two [H, W, C] images in [0, max_val]."""
    k = _gaussian_kernel(device=img1.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    img1, img2 = img1.float(), img2.float()
    mu1 = _filter2d_separable(img1, k)
    mu2 = _filter2d_separable(img2, k)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_separable(img1 * img1, k) - mu1_sq
    sigma2_sq = _filter2d_separable(img2 * img2, k) - mu2_sq
    sigma12 = _filter2d_separable(img1 * img2, k) - mu12
    lum = (2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return torch.mean(lum * cs)


def psnr(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    mse = torch.mean(torch.square(img1.float() - img2.float()))
    return 10.0 * torch.log10(max_val ** 2 / mse)


def remove_pole(img):
    """Crop the top and bottom quarters (eval.py:55-60)."""
    h = img.shape[0]
    return img[h // 4: h - h // 4]


def gaussian_blur(img: torch.Tensor, size: int = 11, sigma: float = 1.5
                  ) -> torch.Tensor:
    """Same-size Gaussian blur (edge-padded) for temporal diffs."""
    k = _gaussian_kernel(size, sigma, device=img.device)
    pad = size // 2
    x = F.pad(img.float().permute(2, 0, 1)[None], (pad,) * 4,
              mode="replicate")
    return _filter2d_separable(x[0].permute(1, 2, 0), k)


def temporal_diff(frame_a: torch.Tensor, frame_b: torch.Tensor
                  ) -> torch.Tensor:
    """Mean |blur(a) - blur(b)|, the video consistency statistic
    (eval.py:147-188)."""
    return torch.mean(torch.abs(gaussian_blur(frame_a)
                                - gaussian_blur(frame_b)))
