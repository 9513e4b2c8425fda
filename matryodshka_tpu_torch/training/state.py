"""Train state: the net, its optimizer and the step count, and model
construction.

Counterpart of `matryodshka_tpu/training/state.py`. The JAX trainer builds
its net with `use_pallas_conv=False`, because on the TPU one custom-call
boundary breaks XLA's cross-layer scheduling (`ops/pallas_conv.py:13-37`);
the card has no such penalty, so the port's trainer runs the stride-1 wrap
convs through the hand-written K7 kernels (`MSIUNet(wrap_conv_kernel=True)`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.models.unet import MSIUNet


@dataclass
class TrainState:
    step: int
    net: MSIUNet
    optimizer: torch.optim.Optimizer
    #: The CPU generator the loss's random draws (E-LPIPS's ensemble) come
    #: from, advanced by every step and checkpointed with the optimizer.
    generator: torch.Generator


def build_model(cfg) -> MSIUNet:
    """The trainer's net: cfg's variant, compute dtype and head, float32
    parameters, the wrap net's stride-1 convs through K7."""
    return MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                   dtype=cfg.torch_compute_dtype, variant=cfg.net_variant,
                   wrap_conv_kernel=True)


def build_optimizer(cfg, net) -> torch.optim.Adam:
    """Adam with the reference hyperparameters (train.py:47-48; TF defaults
    beta2=0.999, eps=1e-8)."""
    return torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                            betas=(cfg.beta1, 0.999), eps=1e-8)


def init_state(cfg, seed: int, device="cuda") -> TrainState:
    """Step 0, the net with weights.seeded_init(cfg, seed) on device (the
    card unless the caller asks for the CPU), a fresh optimizer, and the
    loss's generator seeded with cfg.random_seed."""
    net = build_model(cfg)
    net.load_state_dict(weights.from_flax(weights.seeded_init(cfg, seed)))
    net = net.to(device).train()
    return TrainState(step=0, net=net, optimizer=build_optimizer(cfg, net),
                      generator=torch.Generator().manual_seed(
                          cfg.random_seed))


def param_count(net) -> int:
    return sum(p.numel() for p in net.parameters())
