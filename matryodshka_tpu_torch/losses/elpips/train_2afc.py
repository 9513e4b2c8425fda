"""2AFC training of the LPIPS linear weights.

Counterpart of `matryodshka_tpu/losses/elpips/train_2afc.py` (the
reference harness, elpips/train.py), with torch.optim.Adam in place of
optax: given triplets (reference image, distortion 0, distortion 1) with
human judgements h in [0, 1] (fraction preferring im1), learn per-channel
linear weights so the metric's ranking matches the judgements.

The ranking head is the reference's BCERankingLoss (train.py:58-76): a
3-layer 1x1 MLP over (d0, d1, d0-d1, d0/(d1+eps), d1/(d0+eps)) producing
a preference logit, trained jointly with the (softplus-constrained,
nonnegative) lin weights by sigmoid cross-entropy, symmetrized over the
(d0, d1) ordering.

Data comes from a darc archive of records named ref/{i}, p0/{i}, p1/{i},
judge/{i} (build one with make_archive below), or any iterator of batch
dicts of [N, H, W, 3] images in [0, 1] and [N] judgements.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from matryodshka_tpu_torch.losses.elpips import api as elpips_api
from matryodshka_tpu_torch.losses.elpips.darc import DataArchive
from matryodshka_tpu_torch.losses.elpips.pnetlin import normalize_tensor


def init_head_params(generator: torch.Generator, chn_mid: int = 32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    s = 0.1

    def normal(*shape):
        return (torch.randn(shape, generator=generator) * s).to(device)

    return {"W1": normal(5, chn_mid),
            "b1": torch.zeros(chn_mid, device=device),
            "W2": normal(chn_mid, chn_mid),
            "b2": torch.zeros(chn_mid, device=device),
            "W3": normal(chn_mid, 1),
            "b3": torch.zeros(1, device=device)}


def ranking_logit(head, d0: torch.Tensor, d1: torch.Tensor,
                  eps: float = 0.1) -> torch.Tensor:
    """The dist2logit MLP (train.py:58-72)."""
    feats = torch.stack([d0, d1, d0 - d1, d0 / (d1 + eps),
                         d1 / (d0 + eps)], dim=-1)
    h = F.leaky_relu(feats @ head["W1"] + head["b1"], 0.2)
    h = F.leaky_relu(h @ head["W2"] + head["b2"], 0.2)
    return (h @ head["W3"] + head["b3"])[..., 0]


def bce_ranking_loss(head, d0, d1, judge):
    return F.binary_cross_entropy_with_logits(ranking_logit(head, d0, d1),
                                              judge)


@dataclasses.dataclass
class TrainConfig:
    metric: str = "lpips_vgg"       # config name; vgg weights fixed
    learning_rate: float = 1e-4
    batch_size: int = 8
    steps: int = 1000
    weight_path: Optional[str] = None
    seed: int = 0


def make_archive(path: str, triplets) -> None:
    """Write (ref, p0, p1, judge) triplets into a darc archive."""
    with DataArchive(path, "w") as db:
        for i, (ref, p0, p1, judge) in enumerate(triplets):
            db.append(np.asarray(ref, np.float32), f"ref/{i}")
            db.append(np.asarray(p0, np.float32), f"p0/{i}")
            db.append(np.asarray(p1, np.float32), f"p1/{i}")
            db.append(np.asarray(judge, np.float32), f"judge/{i}")


def archive_batches(path: str, batch_size: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    db = DataArchive(path, "r")
    n = len(db) // 4
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.randint(0, n, size=batch_size)
        yield {
            "ref": np.stack([db.read(f"ref/{i}") for i in idx]),
            "p0": np.stack([db.read(f"p0/{i}") for i in idx]),
            "p1": np.stack([db.read(f"p1/{i}") for i in idx]),
            "judge": np.stack([db.read(f"judge/{i}") for i in idx]
                              ).reshape(batch_size),
        }


def train(cfg: TrainConfig, batches: Iterator[Dict[str, np.ndarray]],
          verbose: bool = True, device="cuda"):
    """Returns (lin_weights dict, head params, final metrics).

    Only the LPIPS linear weights + ranking head are trained (the
    reference's default 'lpips' trainable mode); the conv tower is fixed.
    Runs on `device` (the card unless the caller asks for the CPU)."""
    metric = elpips_api.Metric(
        elpips_api.get_config(cfg.metric, batch_size=cfg.batch_size),
        weight_path=cfg.weight_path).to(device)
    net = metric.network.net
    chans = net.tap_channels
    shift, scale = metric.network.shift, metric.network.scale

    gen = torch.Generator().manual_seed(cfg.seed)
    # raw params; effective lin weight = softplus(raw) >= 0
    lin = {f"lin{i}": torch.full((c,), -2.0, device=device)
           for i, c in enumerate(chans)}
    head = init_head_params(gen, device=device)
    params = list(lin.values()) + list(head.values())
    for p in params:
        p.requires_grad_(True)

    def distances(im, ref):
        taps = net(((im - shift) / scale, (ref - shift) / scale))
        d = 0.0
        for i, tap in enumerate(taps):
            diff = torch.square(normalize_tensor(tap[0])
                                - normalize_tensor(tap[1])).mean(dim=(2, 3))
            d = d + torch.sum(diff * F.softplus(lin[f"lin{i}"]), dim=-1)
        return d

    opt = torch.optim.Adam(params, lr=cfg.learning_rate)
    loss = acc = torch.zeros(())
    for i in range(cfg.steps):
        b = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
             for k, v in next(batches).items()}
        ref, p0, p1 = (b[k].permute(0, 3, 1, 2) for k in ("ref", "p0", "p1"))
        judge = b["judge"]
        d0, d1 = distances(p0, ref), distances(p1, ref)
        loss = 0.5 * (bce_ranking_loss(head, d0, d1, judge)
                      + bce_ranking_loss(head, d1, d0, 1.0 - judge))
        acc = torch.mean((d1 < d0).float() * judge
                         + (d1 >= d0).float() * (1.0 - judge))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if verbose and (i + 1) % 100 == 0:
            print(f"[2afc] step {i+1}: loss={float(loss):.4f} "
                  f"acc={float(acc):.3f}")

    lin_weights = {
        f"lin{i}.model.1.weight": F.softplus(lin[f"lin{i}"]).detach().cpu(
        ).numpy().reshape(1, 1, -1, 1) for i in range(len(chans))}
    head = {k: v.detach() for k, v in head.items()}
    return lin_weights, head, {"loss": float(loss), "accuracy": float(acc)}
