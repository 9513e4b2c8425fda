"""Inputs that more than one traffic driver draws from the run's generator."""

from __future__ import annotations

import math

import torch


def targets(gen, n: int, radius: float, device):
    """n seeded targets: rotations [n, 4, 4] (yaw about the vertical axis)
    and positions [n, 3] within `radius` of the rig centre."""
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)
    r = radius * torch.rand((n, 1), generator=gen, device=device) ** (1 / 3)
    yaw = (torch.rand((n,), generator=gen, device=device) * 2 - 1) * math.pi
    rot = torch.eye(4, device=device).repeat(n, 1, 1)
    rot[:, 0, 0], rot[:, 0, 2] = torch.cos(yaw), torch.sin(yaw)
    rot[:, 2, 0], rot[:, 2, 2] = -torch.sin(yaw), torch.cos(yaw)
    return rot.contiguous(), (d * r).contiguous()
