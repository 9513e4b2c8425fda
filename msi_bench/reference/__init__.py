"""The benchmark's plain reference: MatryODShka's inference in plain PyTorch.

Float32 with TF32 off (`exact()`), no kernels, no caches, no batching. It
imports nothing of the measured program and takes nothing the program made:
it reads the benchmark's own flax-layout weight tree and inputs.

Modules:
  geometry  equirectangular grids, the ODS projection, ray/shell lookups
  sweep     the identity-pose dual-eye ODS sphere sweep (the net's input)
  unet      the MSI U-Net, wrap and coord variants
  render    blend_psv's blend-fused render of a view (the video request)
  hres      the 4096x2048 re-render (the test CLI's high_res_only request)
  quant     the control's storage rounding (fp8 e4m3, per-tensor scale)

`video_view` and `hres_render` are the two requests end to end.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact():
    """Float32 matmuls and convolutions without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


from msi_bench.reference import unet  # noqa: E402
from msi_bench.reference.hres import hres_render  # noqa: E402,F401
from msi_bench.reference.render import render_view  # noqa: E402
from msi_bench.reference.sweep import sweep  # noqa: E402


def video_view(tree, variant: str, ngf: int, ref, src, psv_depths,
               msi_depths, r, rot, pos, q=None):
    """One video frame: ref, src [H, W, 3] in [0, 1] -> the view [H, W, 3]
    in [-1, 1] from position pos [3] turned by rot [4, 4]. The sweep
    volume, the net's prediction and the view, in float32 (q: the
    control's rounding of what the program stores)."""
    q = q or (lambda t: t)
    with exact():
        vol = q(sweep(ref[None], src[None], psv_depths, r))
        pred = unet.forward(tree, vol, variant, ngf, q)
        return render_view(vol[0], pred[0], rot, pos, msi_depths)
