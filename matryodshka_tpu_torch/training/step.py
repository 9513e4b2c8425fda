"""The training step: forward, synthesis, loss, Adam update.

Counterpart of `matryodshka_tpu/training/step.py` for the ODS trainer with
target supervision and the PP / RealEstate trainers (MSI.build_train_graph,
matryodshka/msi.py:550-733):

  supervision 'tgt':     render at the tgt offset, weight 1 (ODS); for PP
      and REALESTATE_PP always the MPI render at tgt_pose @ ref_pose_inv
      (JAX step.py:163-171);
  transform_inverse_reg: a second forward of the batch at a random jitter
      pose through the same net (the gather sweep at ref_pose_inv @
      jitter_pose_inv); its MSI rendered at the jitter pose (its MPI at
      tgt_pose @ ref_pose_inv @ jitter_pose_inv), and
      total += 10 * enforcement, enforcement = d(that render, the
      unjittered render), the gradient flowing through both renders
      (JAX step.py:98-110, 145-152, 172-182);
  wreg:                  + 0.001 * sum_v l2(v)  (msi.py:721-725).

The distance is the pixel loss, 0.5*sum(sq) (losses/basic.py), or with
which_loss=elpips the batch mean of E-LPIPS (losses/elpips) between the
[-1, 1] render and the preprocessed target; the metric applies its own
2x - 1 on top, as the JAX trainer's does (api.py:205). Spherical
attention multiplies both images by the latitude map before the
distance. The step's random draws come from its CPU generator
(TrainState.generator, seeded from cfg.random_seed and checkpointed), in
this order: the jitter pose (three angles, then three offsets), then
E-LPIPS's ensembles (the reconstruction term's, then the enforcement
term's). The src/ref supervisions, hrestgt, the GCN and remat_network
raise NotImplementedError naming their ROADMAP item
(config.check_trainable).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from matryodshka_tpu_torch.config import check_trainable
from matryodshka_tpu_torch.geometry import cameras
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
    """loss(batch, generator, jitter_pose) -> (total_loss, aux dict),
    differentiable in the net's parameters, in parts that can be run (and
    timed) one by one: `sweep(batch)` -> the net input, `net(vol)` -> the
    prediction, `render(vol, pred, batch)` -> assembly and the tgt render,
    and with transform_inverse_reg `draw_jitter(generator)` -> the jitter
    pose, `sweep_jitter(batch, pose)` -> the jittered net input and
    `render_jitter(vol_j, pred_j, batch, pose)` -> its assembly and render
    at the pose; `tail(batch, vol, pred, generator, jitter)` renders and
    adds the losses (jitter: (pose, vol_j, pred_j)).

    sweep: (cfg, batch, psv_depths) -> [B, 2*P*3, H, W] in the compute
    dtype, for the unjittered forward; models/msi.py:sweep_stage (the K1
    kernel for ODS, the gather sweeps for PP and REALESTATE_PP) by
    default. The jittered forward always takes sweep_stage's
    gather route. elpips: (pred, target, generator) -> [B] distances, for
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
        #: The target term: ODS with tgt supervision; PP and RealEstate
        #: always (JAX step.py:163-171 has no supervision switch there).
        self.supervised = cfg.supervise_tgt or cfg.input_type != "ODS"

    def sweep(self, batch):
        return self._sweep(self.cfg, batch, self.psv_depths)

    def draw_jitter(self, generator=None) -> torch.Tensor:
        """The regularizer's jitter pose [4, 4] on the net's device."""
        return cameras.random_jitter_pose(
            generator, self.cfg.rot_factor, self.cfg.tr_factor,
            device=self.psv_depths.device)

    def sweep_jitter(self, batch, jitter_pose):
        """The jittered forward's net input: the gather sweep at
        ref_pose_inv @ inverse(jitter_pose) (for REALESTATE_PP
        inverse(ref_pose) @ inverse(jitter_pose))."""
        b = batch["ref_image"].shape[0]
        inv = torch.linalg.inv(jitter_pose).expand(b, 4, 4)
        return msi_lib.sweep_stage(self.cfg, batch, self.psv_depths,
                                   jitter_pose_inv=inv)

    def distance(self, pred, target, generator=None) -> torch.Tensor:
        """The configured distance of two [B, H, W, 3] images (JAX
        step.py:60-69)."""
        if self.cfg.which_loss != "elpips":
            return l2_loss(pred, target, self.sph_w)
        if self.sph_w is not None:
            pred, target = pred * self.sph_w, target * self.sph_w
        return torch.mean(self.elpips(pred, target, generator))

    def view(self, rgba, batch, jitter_pose=None):
        """The supervised view of layers rgba [B, H, W, P, 4]: for ODS the
        ERP render at the tgt offset (under jitter_pose [4, 4], the
        regularizer's); for PP / REALESTATE_PP the MPI render at
        tgt_pose @ ref_pose_inv [@ inverse(jitter_pose)] (JAX
        step.py:163-182)."""
        b = rgba.shape[0]
        if self.cfg.input_type == "ODS":
            pose = torch.eye(4, device=rgba.device) if jitter_pose is None \
                else jitter_pose
            return msi_lib.render_equirect_view(
                rgba, pose.expand(b, 4, 4), batch["tgt_pose"],
                self.msi_depths)
        inv = None if jitter_pose is None else \
            torch.linalg.inv(jitter_pose).expand(b, 4, 4)
        return msi_lib.render_mpi_view(
            rgba, msi_lib.mpi_view_pose(batch, inv), self.msi_depths,
            batch["intrinsics"])

    def _render(self, vol, pred, batch, jitter_pose, keys):
        """{keys[0]: the assembled layers, keys[1]: with tgt supervision
        their view}."""
        rgba = msi_lib.assemble_train(self.cfg, vol, pred)["rgba_layers"]
        out = {keys[0]: rgba}
        if self.supervised:
            out[keys[1]] = self.view(rgba, batch, jitter_pose)
        return out

    def render(self, vol, pred, batch) -> Dict:
        """Assembly, then with tgt supervision the target view:
        {rgba_layers, output_image ([-1, 1])}."""
        return self._render(vol, pred, batch, None,
                            ("rgba_layers", "output_image"))

    def render_jitter(self, vol_j, pred_j, batch, jitter_pose) -> Dict:
        """The jittered forward's assembly and, with tgt supervision, its
        view under the jitter pose: {rgba_layers_jitter,
        jitter_output_image}."""
        return self._render(vol_j, pred_j, batch, jitter_pose,
                            ("rgba_layers_jitter", "jitter_output_image"))

    def tail(self, batch, vol, pred, generator=None, jitter=None
             ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        aux: Dict = self.render(vol, pred, batch)
        if jitter is not None:
            aux.update(self.render_jitter(jitter[1], jitter[2], batch,
                                          jitter[0]))
        total = torch.zeros((), device=vol.device)
        if self.supervised:
            rec = self.distance(aux["output_image"], msi_lib.preprocess_image(
                batch["tgt_image"]), generator)
            aux["reconstruction_loss"] = rec
            total = total + rec
            if jitter is not None:
                enf = self.distance(aux["jitter_output_image"],
                                    aux["output_image"], generator)
                aux["enforcement_loss"] = enf
                total = total + 10.0 * enf
        if cfg.wreg:
            wsum = 0.5 * sum(torch.sum(torch.square(p))
                             for p in self.net.parameters())
            aux["weight_reg_loss"] = 0.001 * wsum
            total = total + 0.001 * wsum
        aux["total_loss"] = total
        return total, aux

    def __call__(self, batch, generator=None, jitter_pose=None
                 ) -> Tuple[torch.Tensor, Dict]:
        """jitter_pose [4, 4] replays a regularizer pose; without one the
        pose is drawn from generator."""
        vol = self.sweep(batch)
        pred = self.net(vol)
        jitter = None
        if self.cfg.transform_inverse_reg:
            pose = self.draw_jitter(generator) if jitter_pose is None \
                else jitter_pose.to(vol.device)
            vol_j = self.sweep_jitter(batch, pose)
            jitter = (pose, vol_j, self.net(vol_j))
        return self.tail(batch, vol, pred, generator, jitter)


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
    state.generator (the jitter pose too); metrics are 0-d tensors
    (total_loss, reconstruction_loss, enforcement_loss with
    transform_inverse_reg, weight_reg_loss with wreg, grad_norm), read by
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
