"""MatryODShka in PyTorch, with hand-written CUDA kernels for Hopper.

The JAX package `matryodshka_tpu` beside this one is the reference; this
package imports neither it nor JAX. It holds the single-frame ODS
inference path: dual-eye sphere sweep -> MSI U-Net -> blend-fused ERP
render, each stage backed by a kernel in `csrc/` (see `ops/`).
"""

from matryodshka_tpu_torch.config import MatryConfig  # noqa: F401
