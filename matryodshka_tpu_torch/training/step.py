"""The training step: forward, synthesis, loss, Adam update.

Counterpart of `matryodshka_tpu/training/step.py` (MSI.build_train_graph,
matryodshka/msi.py:550-733), every option of its trainer:

  supervision 'tgt':     render at the tgt offset, weight 1 (ODS); for PP
      and REALESTATE_PP always the MPI render at tgt_pose @ ref_pose_inv
      (JAX step.py:163-171);
  supervision 'hrestgt': the high-res layers (models/msi.py:
      assemble_hres_rgba: the low-res blend weights and alphas upsampled
      onto the sweep of the batch's hres_ref_image / hres_src_image)
      rendered at the tgt offset against hres_tgt_image, weight 1 (ODS;
      JAX step.py:130-134);
  supervision 'src'/'ref': the ODS eyes re-rendered from the layers
      (render_ods_view, order -1 / +1) against src_image / ref_image,
      weight 1e-4, or 1 with transform_inverse_reg (JAX step.py:135-143);
  transform_inverse_reg: a second forward of the batch at a random jitter
      pose through the same net (the gather sweep at ref_pose_inv @
      jitter_pose_inv); its MSI rendered at the jitter pose (its MPI at
      tgt_pose @ ref_pose_inv @ jitter_pose_inv), and
      total += 10 * enforcement, enforcement = d(that render, the
      unjittered render), the gradient flowing through both renders
      (JAX step.py:98-110, 145-152, 172-182); with src/ref supervision
      also the eyes re-rendered at the jitter pose, weight 1. As in the
      JAX step (step.py:153-162) those jittered eye renders read the
      UNJITTERED layers, not the jittered forward's;
  wreg:                  + 0.001 * sum_v l2(v)  (msi.py:721-725);
  remat_network:         the net's forward under torch.utils.checkpoint
      (non-reentrant), in both forwards of the regularizer: its
      activations are recomputed in the backward (JAX step.py:76-81);
  gcn:                   the GCN in place of the U-Net (JAX step.py:82-90,
      msi.py:687-727): its prediction from the per-vertex sweep
      (models/msi.gcn_predict, with autograd), scattered onto the pixel
      grid and assembled against the float32 sweep volume (sweep_stage:
      K1 on the card; it needs no gradient); then the same render and
      terms. Not with transform_inverse_reg or hrestgt (config.check_gcn).

Data parallelism: in a process group (parallel/mesh.py) make_train_step
runs this loss on the rank's shard of the global batch (parallel/dp.py:
shard_batch) with n_shards = the rank count, and one all-reduce SUMS the
gradients and the scalar metrics over the ranks before the replicated
Adam update, as the JAX package psums them under shard_map (JAX
dp.py:73-76), not DDP's mean: the mean-type terms, E-LPIPS's batch mean
and the weight regularizer, are divided by n_shards here, so the sum
reproduces the global batch's loss; the sum-type pixel loss (0.5 * sum
of squares) rides the sum unscaled. The ranks start from rank 0's
parameters and apply the same update, so they stay equal. With more
than one rank each draws from its own generator seeded from (seed, step,
rank) (rank_generator), so the ranks' E-LPIPS ensembles and jitter poses
differ, as the JAX step folds the shard index into its key (JAX
dp.py:70-71).

The distance is the pixel loss, 0.5*sum(sq) (losses/basic.py), or with
which_loss=elpips the batch mean of E-LPIPS (losses/elpips) between the
[-1, 1] render and the preprocessed target; the metric applies its own
2x - 1 on top, as the JAX trainer's does (api.py:205). Spherical
attention multiplies both images by the latitude map before the
distance.

The step's random draws come from its CPU generator
(TrainState.generator, seeded from cfg.random_seed and checkpointed; a
rank's rank_generator with more than one rank), in this order:
  1. the jitter pose (three angles, then three offsets), with
     transform_inverse_reg;
  2. E-LPIPS's ensembles (cfg.elpips_average_over draws each), one set
     per distinct key of the JAX step (step.py:74-75), in its key order,
     for the terms the configuration has: tgt (rng_l1; the target term of
     PP and RealEstate too), hrestgt (rng_l2), src (rng_l3), ref (rng_l4),
     enforcement (rng_l5);
  3. none more: the jittered eye terms reuse the src and ref terms' keys
     in the JAX step, so here they reuse those very draws (the transforms
     and the dropout masks).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from matryodshka_tpu_torch.geometry import cameras
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.losses.basic import l2_loss, spherical_weights
from matryodshka_tpu_torch.losses.elpips import api as elpips_api
from matryodshka_tpu_torch.models import msi as msi_lib

#: The E-LPIPS keys of the JAX step's terms, in its key order
#: (step.py:74-75).
TERM_KEYS = ("tgt", "hrestgt", "src", "ref", "enforcement")


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
    timed) one by one: `sweep(batch)` -> the net input, `net_forward(vol)`
    -> the prediction (under remat_network recomputed in the backward),
    `render(vol, pred, batch)` -> assembly and the tgt render, with
    hrestgt supervision `sweep_hres(batch)` -> the high-res volume and
    `render_hres(vol_h, outputs, batch)` -> its layers' render, and with
    transform_inverse_reg `draw_jitter(generator)` -> the jitter pose,
    `sweep_jitter(batch, pose)` -> the jittered net input and
    `render_jitter(vol_j, pred_j, batch, pose)` -> its assembly and render
    at the pose; `tail(batch, vol, pred, generator, jitter, vol_h)`
    renders and adds the losses (jitter: (pose, vol_j, pred_j)).

    sweep: (cfg, batch, psv_depths) -> [B, C, H, W] in the compute dtype at
    the size of the batch's images, for the unjittered forward and the
    high-res volume (given the batch with its high-res pair as
    ref_image / src_image);
    models/msi.py:sweep_stage (the K1 kernel for ODS, the gather sweeps
    for PP and REALESTATE_PP and with use_pallas false) by default. The
    jittered forward always takes sweep_stage's gather route. elpips: a
    losses/elpips Metric, which the loss gives each term's draws (module
    docstring), or any (pred, target, generator) -> [B] distances, called
    once per term in the JAX step's order and given the generator to draw
    from; build_elpips(cfg, ...) by default for which_loss=elpips."""

    def __init__(self, cfg, net, sweep: Optional[Callable] = None,
                 elpips: Optional[Callable] = None, gcn_inputs=None,
                 n_shards: int = 1):
        cfg.validate()
        if cfg.gcn and gcn_inputs is None:
            raise ValueError("cfg.gcn needs gcn_inputs, the mesh's (coords, "
                             "p2v) (training/state.build_gcn)")
        self.cfg = cfg
        self.net = net
        self.gcn_inputs = gcn_inputs
        self.n_shards = n_shards
        self._sweep = sweep or msi_lib.sweep_stage
        #: the config the sweep volume is made with: the GCN assembles in
        #: float32 (models/msi.gcn_cfg)
        self._sweep_cfg = msi_lib.gcn_cfg(cfg) if cfg.gcn else cfg
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
        ods = cfg.input_type == "ODS"
        #: The target term: ODS with tgt supervision; PP and RealEstate
        #: always (JAX step.py:163-171 has no supervision switch there).
        self.supervised = cfg.supervise_tgt or not ods
        #: The terms this configuration has, in TERM_KEYS order.
        self.terms = [k for k, on in zip(TERM_KEYS, (
            self.supervised, ods and cfg.supervise_hrestgt,
            ods and cfg.supervise_src, ods and cfg.supervise_ref,
            cfg.transform_inverse_reg and self.supervised)) if on]

    def sweep(self, batch):
        return self._sweep(self._sweep_cfg, batch, self.psv_depths)

    def sweep_hres(self, batch):
        """The high-res volume [B, 2*P*3, hres_height, hres_width] of the
        batch's hres_ref_image / hres_src_image, through the same sweep (on
        the card K1 at the high-res size), with the batch's poses and
        low-res intrinsics, as JAX infer_msi(with_hres=True) sweeps
        (msi.py:384-390; for ODS intrinsics[0, 0] is the viewing circle's
        radius, which does not depend on the resolution)."""
        hres = dict(batch, ref_image=batch["hres_ref_image"],
                    src_image=batch["hres_src_image"])
        return self._sweep(self.cfg, hres, self.psv_depths)

    def net_forward(self, x):
        """The net's output for its input x (the U-Net's prediction of the
        volume, the GCN's of the vertex sweep); with remat_network its
        activations are not kept but recomputed in the backward."""
        if self.cfg.remat_network:
            return checkpoint(self.net, x, use_reentrant=False)
        return self.net(x)

    def predict(self, batch, vol):
        """The prediction [B, K, H, W]: the U-Net's of vol, or the GCN's of
        the batch (models/msi.gcn_predict through net_forward)."""
        if self.cfg.gcn:
            return msi_lib.gcn_predict(
                self.net, batch, self.psv_depths, *self.gcn_inputs,
                apply=lambda _, x: self.net_forward(x))
        return self.net_forward(vol)

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

    def draw_terms(self, batch_size: int, generator=None) -> Dict:
        """{term: what distance() needs for it}: for a Metric, each term's
        cfg.elpips_average_over draws from generator, in TERM_KEYS order;
        for another E-LPIPS callable, the generator; for the pixel loss
        None."""
        if self.cfg.which_loss != "elpips":
            return {k: None for k in self.terms}
        if not isinstance(self.elpips, elpips_api.Metric):
            return {k: generator for k in self.terms}
        g = torch.default_generator if generator is None else generator
        return {k: [self.elpips.draw(batch_size, g)
                    for _ in range(self.cfg.elpips_average_over)]
                for k in self.terms}

    def distance(self, pred, target, term=None) -> torch.Tensor:
        """The configured distance of two [B, H, W, 3] images (JAX
        step.py:60-69); term: draw_terms' entry of the term."""
        if self.cfg.which_loss != "elpips":
            return l2_loss(pred, target, self.sph_w)
        if self.sph_w is not None:
            pred, target = pred * self.sph_w, target * self.sph_w
        if isinstance(self.elpips, elpips_api.Metric):
            d = self.elpips(pred, target, draws=term)
        else:
            d = self.elpips(pred, target, term)
        # a batch mean: the global batch's is the sum over ranks of / K
        return torch.mean(d) / self.n_shards

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

    def eye_view(self, rgba, batch, order: int, jitter_pose=None):
        """The ODS eye (order -1: src, +1: ref) re-rendered from layers
        rgba [B, H, W, P, 4] at the identity or at jitter_pose (JAX
        step.py:137-143, 153-162)."""
        b = rgba.shape[0]
        pose = torch.eye(4, device=rgba.device) if jitter_pose is None \
            else jitter_pose
        return msi_lib.render_ods_view(rgba, order, pose.expand(b, 4, 4),
                                       batch["tgt_pose"], self.msi_depths,
                                       batch["intrinsics"])

    def _render(self, vol, pred, batch, jitter_pose, keys):
        """assemble_train's dict with the layers under keys[0], and with
        the target term their view under keys[1]."""
        out = msi_lib.assemble_train(self.cfg, vol, pred)
        out[keys[0]] = out.pop("rgba_layers")
        if self.supervised:
            out[keys[1]] = self.view(out[keys[0]], batch, jitter_pose)
        return out

    def render(self, vol, pred, batch) -> Dict:
        """Assembly, then with the target term the target view:
        {rgba_layers, output_image ([-1, 1]), and assemble_rgba's blend
        weights and alphas}."""
        return self._render(vol, pred, batch, None,
                            ("rgba_layers", "output_image"))

    def render_jitter(self, vol_j, pred_j, batch, jitter_pose) -> Dict:
        """The jittered forward's assembly and, with the target term, its
        view under the jitter pose: {rgba_layers_jitter,
        jitter_output_image}."""
        out = self._render(vol_j, pred_j, batch, jitter_pose,
                           ("rgba_layers_jitter", "jitter_output_image"))
        return {k: out[k] for k in ("rgba_layers_jitter",
                                    "jitter_output_image") if k in out}

    def render_hres(self, vol_h, outputs, batch):
        """The high-res layers (assemble_hres_rgba of the low-res
        assembly's blend weights and alphas onto vol_h) rendered at the
        tgt offset -> [B, hres_height, hres_width, 3] in [-1, 1] (JAX
        step.py:131-133). The gather render, with autograd, as the JAX
        step's."""
        rgba = msi_lib.assemble_hres_rgba(self.cfg.which_color_pred,
                                          outputs, vol_h,
                                          self.cfg.num_msi_planes)
        b = rgba.shape[0]
        return msi_lib.render_equirect_view(
            rgba, torch.eye(4, device=rgba.device).expand(b, 4, 4),
            batch["tgt_pose"], self.msi_depths)

    def tail(self, batch, vol, pred, generator=None, jitter=None,
             vol_h=None) -> Tuple[torch.Tensor, Dict]:
        """The losses of the forward's outputs, in the JAX step's order
        (step.py:123-182); vol_h: sweep_hres(batch), with hrestgt
        supervision."""
        cfg = self.cfg
        out = self.render(vol, pred, batch)
        rgba = out["rgba_layers"]
        aux: Dict = {k: out[k] for k in ("rgba_layers", "output_image")
                     if k in out}
        pose = None
        if jitter is not None:
            pose = jitter[0]
            aux.update(self.render_jitter(jitter[1], jitter[2], batch, pose))
        terms = self.draw_terms(rgba.shape[0], generator)
        total = torch.zeros((), device=vol.device)
        if self.supervised:
            rec = self.distance(aux["output_image"], msi_lib.preprocess_image(
                batch["tgt_image"]), terms["tgt"])
            aux["reconstruction_loss"] = rec
            total = total + rec
        if "hrestgt" in terms:
            total = total + self.distance(
                self.render_hres(vol_h, out, batch),
                msi_lib.preprocess_image(batch["hres_tgt_image"]),
                terms["hrestgt"])
        eyes = [(k, order, msi_lib.preprocess_image(batch[k + "_image"]))
                for k, order in (("src", -1), ("ref", 1)) if k in terms]
        src_w = 1.0 if cfg.transform_inverse_reg else 1e-4
        for k, order, target in eyes:
            total = total + src_w * self.distance(
                self.eye_view(rgba, batch, order), target, terms[k])
        if jitter is not None:
            if "enforcement" in terms:
                enf = self.distance(aux["jitter_output_image"],
                                    aux["output_image"], terms["enforcement"])
                aux["enforcement_loss"] = enf
                total = total + 10.0 * enf
            for k, order, target in eyes:
                # the unjittered layers at the jitter pose, the unjittered
                # term's draws (JAX step.py:153-162: rgba, rng_l3 / rng_l4)
                total = total + self.distance(
                    self.eye_view(rgba, batch, order, pose), target,
                    terms[k])
        if cfg.wreg:
            # batch-independent: the sum over ranks of / K is itself
            wsum = 0.5 * sum(torch.sum(torch.square(p))
                             for p in self.net.parameters()) / self.n_shards
            aux["weight_reg_loss"] = 0.001 * wsum
            total = total + 0.001 * wsum
        aux["total_loss"] = total
        return total, aux

    def __call__(self, batch, generator=None, jitter_pose=None
                 ) -> Tuple[torch.Tensor, Dict]:
        """jitter_pose [4, 4] replays a regularizer pose; without one the
        pose is drawn from generator."""
        vol = self.sweep(batch)
        pred = self.predict(batch, vol)
        jitter = None
        if self.cfg.transform_inverse_reg:
            pose = self.draw_jitter(generator) if jitter_pose is None \
                else jitter_pose.to(vol.device)
            vol_j = self.sweep_jitter(batch, pose)
            jitter = (pose, vol_j, self.net_forward(vol_j))
        vol_h = self.sweep_hres(batch) if "hrestgt" in self.terms else None
        return self.tail(batch, vol, pred, generator, jitter, vol_h)


def make_loss_fn(cfg, net, sweep: Optional[Callable] = None,
                 elpips: Optional[Callable] = None, gcn_inputs=None,
                 n_shards: int = 1) -> TrainLoss:
    """The loss of cfg's trainer for net; see TrainLoss. gcn_inputs: the
    mesh's (coords, p2v) with cfg.gcn; n_shards: the data-parallel ranks
    the loss runs under (module docstring)."""
    return TrainLoss(cfg, net, sweep, elpips, gcn_inputs, n_shards)


def scalar_metrics(aux: Dict) -> Dict[str, torch.Tensor]:
    """The detached scalars of a loss's aux dict."""
    return {k: v.detach() for k, v in aux.items()
            if torch.is_tensor(v) and v.dim() == 0}


def grad_norm(params) -> torch.Tensor:
    """Global L2 norm of the parameters' gradients (optax.global_norm)."""
    return torch.stack([p.grad.norm() for p in params
                        if p.grad is not None]).norm()


def rank_generator(seed: int, step: int, rank: int) -> torch.Generator:
    """The CPU generator of a rank's draws at a step: seeded from (seed,
    step, rank), so it needs no state of its own in a checkpoint."""
    key = np.random.SeedSequence([seed, step, rank]).generate_state(2)
    return torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))


def _sum_over_ranks(params, metrics: Dict, group=None) -> Dict:
    """All-reduce (SUM) the parameters' gradients in place, as one flat
    buffer, and the scalar metrics; returns the summed metrics."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    return dict(zip(keys, vals))


def make_train_step(cfg, net, sweep: Optional[Callable] = None,
                    elpips: Optional[Callable] = None,
                    gcn_inputs=None, group=None) -> Callable:
    """train_step(state, batch) -> (state, metrics): one Adam step of
    state.optimizer on the loss of `net` (state.net), E-LPIPS drawing from
    state.generator (the jitter pose too); metrics are 0-d tensors
    (total_loss, reconstruction_loss, enforcement_loss with
    transform_inverse_reg, weight_reg_loss with wreg, grad_norm), read by
    the caller when it needs them. gcn_inputs: TrainState.gcn_inputs with
    cfg.gcn.

    Built in a process group (group, or the default one), the step is
    data-parallel (module docstring): batch is this rank's shard, and the
    gradients and metrics are summed over the ranks (grad_norm is the
    summed gradient's). In a group of one rank that sum is the identity."""
    in_group = dist.is_initialized()
    rank, world = ((dist.get_rank(group), dist.get_world_size(group))
                   if in_group else (0, 1))
    if world > 1:
        for p in net.parameters():
            dist.broadcast(p.data, src=0, group=group)
    loss_fn = make_loss_fn(cfg, net, sweep, elpips, gcn_inputs,
                           n_shards=world)
    params = list(net.parameters())

    def train_step(state, batch):
        gen = state.generator if world == 1 else rank_generator(
            cfg.random_seed, state.step, rank)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, gen)
        loss.backward()
        metrics = scalar_metrics(aux)
        if in_group:
            metrics = _sum_over_ranks(params, metrics, group)
        metrics["grad_norm"] = grad_norm(params)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step
