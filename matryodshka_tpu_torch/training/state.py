"""Train state: the net, its optimizer and the step count, and model
construction (the U-Net, or the GCN with its mesh, build_gcn).

Counterpart of `matryodshka_tpu/training/state.py`. The JAX trainer builds
its net with `use_pallas_conv=False`, because on the TPU one custom-call
boundary breaks XLA's cross-layer scheduling (`ops/pallas_conv.py:13-37`);
the card has no such penalty, so the port's trainer runs the stride-1 wrap
convs through the hand-written K7 kernels (`MSIUNet(wrap_conv_kernel=True)`),
unless cfg.use_pallas is false (then PyTorch's convs, as the JAX trainer's
XLA convs). The net's parameters, and so Adam's moments, are in
cfg.param_dtype (JAX training/state.py:35); the seeded float32 tree is cast
to it when it is loaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.geometry import icosphere
from matryodshka_tpu_torch.models.gcn import GCNNet, SparseSupport
from matryodshka_tpu_torch.models.unet import MSIUNet


@dataclass
class TrainState:
    step: int
    #: The trainer's net: an MSIUNet, or a GCNNet with cfg.gcn.
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    #: The CPU generator the loss's random draws (E-LPIPS's ensemble) come
    #: from, advanced by every step and checkpointed with the optimizer.
    generator: torch.Generator
    #: (mesh coords [V, 3], p2v [W, H, 3, 2]) on the net's device with
    #: cfg.gcn (build_gcn), else None.
    gcn_inputs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def build_model(cfg) -> MSIUNet:
    """The trainer's net: cfg's variant, upsampling (cfg.smoothed), compute
    dtype and head, parameters in cfg.param_dtype, the wrap net's stride-1
    convs through K7 when cfg.use_pallas."""
    return MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                   dtype=cfg.torch_compute_dtype, variant=cfg.net_variant,
                   wrap_conv_kernel=cfg.use_pallas,
                   smoothed=cfg.smoothed).to(cfg.torch_param_dtype)


def build_gcn(cfg, device="cuda"):
    """The GCN variant (JAX training/state.py:39-52): (GCNNet, mesh coords
    [V, 3], p2v [W, H, 3, 2]), float32 on device, the net's parameters
    zero until loaded. The mesh is read from, or generated into, the
    cache under cfg.mesh_dir (geometry/icosphere.load_mesh_input)."""
    coords, supports, p2v = icosphere.load_mesh_input(
        cfg.subdiv, cfg.height, cfg.width, cfg.mesh_dir)
    sups = [SparseSupport(*sup, num_verts=len(coords)) for sup in supports]
    net = GCNNet(cfg.num_net_inputs(), cfg.num_net_outputs(), sups,
                 ngf=cfg.ngf).to(device)
    return (net, torch.as_tensor(coords, device=device),
            torch.as_tensor(p2v, device=device))


def build_optimizer(cfg, net) -> torch.optim.Adam:
    """Adam with the reference hyperparameters (train.py:47-48; TF defaults
    beta2=0.999, eps=1e-8)."""
    return torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                            betas=(cfg.beta1, 0.999), eps=1e-8)


def init_state(cfg, seed: int, device="cuda") -> TrainState:
    """Step 0, the net with weights.seeded_init(cfg, seed) (cast to
    cfg.param_dtype) on device (the card unless the caller asks for the
    CPU), a fresh optimizer, and the loss's generator seeded with
    cfg.random_seed. With cfg.gcn the net is build_gcn's GCNNet (float32,
    as the JAX GCN's parameters are) and gcn_inputs its mesh."""
    tree = weights.seeded_init(cfg, seed)
    gcn_inputs = None
    if cfg.gcn:
        net, *gcn_inputs = build_gcn(cfg, device)
        net.load_state_dict(weights.gcn_from_flax(tree))
        gcn_inputs = tuple(gcn_inputs)
    else:
        net = build_model(cfg)
        net.load_state_dict(weights.from_flax(tree))
    net = net.to(device).train()
    return TrainState(step=0, net=net, optimizer=build_optimizer(cfg, net),
                      generator=torch.Generator().manual_seed(
                          cfg.random_seed), gcn_inputs=gcn_inputs)


def param_count(net) -> int:
    return sum(p.numel() for p in net.parameters())
