"""The training step: forward, synthesis, loss, Adam update.

Counterpart of `matryodshka_tpu/training/step.py` for the ODS trainer with
target supervision (MSI.build_train_graph, matryodshka/msi.py:550-733):

  supervision 'tgt': render at the tgt offset, weight 1;
  wreg:              + 0.001 * sum_v l2(v)  (msi.py:721-725).

The distance is the pixel loss, 0.5*sum(sq) (losses/basic.py), or with
which_loss=elpips the batch mean of E-LPIPS (losses/elpips) between the
[-1, 1] render and the preprocessed target; the metric applies its own
2x - 1 on top, as the JAX trainer's does (api.py:205). Spherical
attention multiplies both images by the latitude map before the
distance. E-LPIPS draws its ensemble from the step's CPU generator
(TrainState.generator, seeded from cfg.random_seed and checkpointed). The
other supervisions, the transform-inverse regularizer, the GCN and
remat_network raise NotImplementedError naming their ROADMAP item
(config.check_trainable).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from matryodshka_tpu_torch.config import check_trainable
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.losses.basic import l2_loss, spherical_weights
from matryodshka_tpu_torch.losses.elpips import api as elpips_api
from matryodshka_tpu_torch.models import msi as msi_lib


def build_elpips(cfg, device) -> elpips_api.Metric:
    """The trainer's E-LPIPS: the VGG ensemble averaged over
    cfg.elpips_average_over draws, weights from cfg.elpips_weight_path
    (random features without one), on device."""
    return elpips_api.Metric(elpips_api.elpips_vgg(
        batch_size=cfg.batch_size, n=cfg.elpips_average_over),
        weight_path=cfg.elpips_weight_path).to(device)


class TrainLoss:
    """loss(batch, generator) -> (total_loss, aux dict), differentiable in
    the net's parameters, in three parts that can be run (and timed) one
    by one: `sweep(batch)` -> the net input, `net(vol)` -> the prediction,
    and `tail(batch, vol, pred, generator)` -> assembly, render and loss.

    sweep: (cfg, batch, psv_depths) -> [B, 2*P*3, H, W] in the compute
    dtype; models/msi.py:sweep_stage (the K1 kernel) by default.
    elpips: (pred, target, generator) -> [B] distances, for
    which_loss=elpips; build_elpips(cfg, ...) by default."""

    def __init__(self, cfg, net, sweep: Optional[Callable] = None,
                 elpips: Optional[Callable] = None):
        check_trainable(cfg)
        self.cfg = cfg
        self.net = net
        self._sweep = sweep or msi_lib.sweep_stage
        device = next(net.parameters()).device
        if cfg.which_loss == "elpips" and elpips is None:
            elpips = build_elpips(cfg, device)
        self.elpips = elpips

        def depths(n):
            return torch.tensor(sweep_lib.inv_depths(cfg.min_depth,
                                                     cfg.max_depth, n),
                                dtype=torch.float32, device=device)

        self.psv_depths = depths(cfg.num_psv_planes)
        self.msi_depths = depths(cfg.num_msi_planes)
        self.sph_w = (spherical_weights(cfg.height, cfg.width,
                                        device=device)[None, :, :, None]
                      if cfg.spherical_attention else None)

    def sweep(self, batch):
        return self._sweep(self.cfg, batch, self.psv_depths)

    def distance(self, pred, target, generator=None) -> torch.Tensor:
        """The configured distance of two [B, H, W, 3] images (JAX
        step.py:60-69)."""
        if self.cfg.which_loss != "elpips":
            return l2_loss(pred, target, self.sph_w)
        if self.sph_w is not None:
            pred, target = pred * self.sph_w, target * self.sph_w
        return torch.mean(self.elpips(pred, target, generator))

    def render(self, vol, pred, batch) -> Dict:
        """Assembly, then with tgt supervision the render at the tgt
        offset: {rgba_layers, output_image ([-1, 1])}."""
        rgba = msi_lib.assemble_train(self.cfg, vol, pred)["rgba_layers"]
        out = {"rgba_layers": rgba}
        if self.cfg.supervise_tgt:
            eye = torch.eye(4, device=rgba.device).expand(rgba.shape[0], 4, 4)
            out["output_image"] = msi_lib.render_equirect_view(
                rgba, eye, batch["tgt_pose"], self.msi_depths)
        return out

    def tail(self, batch, vol, pred, generator=None
             ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        aux: Dict = self.render(vol, pred, batch)
        total = torch.zeros((), device=vol.device)
        if cfg.supervise_tgt:
            rec = self.distance(aux["output_image"], msi_lib.preprocess_image(
                batch["tgt_image"]), generator)
            aux["reconstruction_loss"] = rec
            total = total + rec
        if cfg.wreg:
            wsum = 0.5 * sum(torch.sum(torch.square(p))
                             for p in self.net.parameters())
            aux["weight_reg_loss"] = 0.001 * wsum
            total = total + 0.001 * wsum
        aux["total_loss"] = total
        return total, aux

    def __call__(self, batch, generator=None) -> Tuple[torch.Tensor, Dict]:
        vol = self.sweep(batch)
        return self.tail(batch, vol, self.net(vol), generator)


def make_loss_fn(cfg, net, sweep: Optional[Callable] = None,
                 elpips: Optional[Callable] = None) -> TrainLoss:
    """The loss of cfg's trainer for net; see TrainLoss."""
    return TrainLoss(cfg, net, sweep, elpips)


def scalar_metrics(aux: Dict) -> Dict[str, torch.Tensor]:
    """The detached scalars of a loss's aux dict."""
    return {k: v.detach() for k, v in aux.items()
            if torch.is_tensor(v) and v.dim() == 0}


def grad_norm(params) -> torch.Tensor:
    """Global L2 norm of the parameters' gradients (optax.global_norm)."""
    return torch.stack([p.grad.norm() for p in params
                        if p.grad is not None]).norm()


def make_train_step(cfg, net, sweep: Optional[Callable] = None,
                    elpips: Optional[Callable] = None) -> Callable:
    """train_step(state, batch) -> (state, metrics): one Adam step of
    state.optimizer on the loss of `net` (state.net), E-LPIPS drawing from
    state.generator; metrics are 0-d tensors (total_loss,
    reconstruction_loss, weight_reg_loss with wreg, grad_norm), read by
    the caller when it needs them."""
    loss_fn = make_loss_fn(cfg, net, sweep, elpips)
    params = list(net.parameters())

    def train_step(state, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, state.generator)
        loss.backward()
        metrics = scalar_metrics(aux)
        metrics["grad_norm"] = grad_norm(params)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step
