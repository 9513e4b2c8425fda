"""Shell-sharded MSI rendering: the counterpart of
`matryodshka_tpu/parallel/sharded_render.py`.

The reference fits its high-resolution render in memory by re-rendering
one shell at a time (test.py:306-394). Split the P shells into contiguous
back-to-front blocks instead, one a rank: for block g,
C_g = sum_{i in g} rgb_i a_i prod_{j in g, j > i} (1 - a_j) and
T_g = prod_{i in g} (1 - a_i), and by the associativity of `over`

    out = sum_g C_g prod_{g' > g} T_{g'},

so each rank composites its own shells and one all_gather of the image-
sized partials (C_g, T_g) finishes the view. Layer 0's alpha is taken as
1 in the block that holds global shell 0, which makes the formula exact.

`render_equirect_view_sharded` is the gather route of one view (JAX's
function); the test CLI's high-res re-render (cli/test.py,
build_hres_render_fn with shards > 1) renders each block with the
layer-stack kernel's partial mode (ops/render_layers.py:
render_layers_partial), whose plain version is partial_composite
(geometry/render.py, beside the full over-composite).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from matryodshka_tpu_torch.geometry import intersect
# partial_composite lives beside over_composite; JAX keeps it here
from matryodshka_tpu_torch.geometry.render import partial_composite
from matryodshka_tpu_torch.ops.resample import resample_layers


def combine_partials(c, t):
    """Composite the blocks' partials back to front along axis 0:
    c [G, ..., C], t [G, ..., 1] -> sum_g c_g prod_{g' > g} t_g'."""
    rcp = torch.flip(torch.cumprod(torch.flip(t, [0]), dim=0), [0])
    ladder = torch.cat([rcp[1:], torch.ones_like(rcp[:1])], dim=0)
    return torch.sum(c * ladder, dim=0)


def shell_blocks(num_planes: int, shards: int) -> List[Tuple[int, int]]:
    """[(p0, p1)] of the shards contiguous blocks of shells, back to
    front; num_planes must divide evenly (JAX asserts so)."""
    if shards < 1 or num_planes % shards:
        raise ValueError(f"{num_planes} shells do not split evenly into "
                         f"{shards} blocks")
    n = num_planes // shards
    return [(g * n, (g + 1) * n) for g in range(shards)]


def gather_partials(parts: Sequence[torch.Tensor], group=None):
    """all_gather each of this rank's partials over group -> each stacked
    [G, ...] in rank order (a rank's block is its rank's)."""
    world = dist.get_world_size(group)
    out = []
    for x in parts:
        bufs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(bufs, x.contiguous(), group=group)
        out.append(torch.stack(bufs))
    return out


def render_equirect_view_sharded(rgba_layers, tgt_pose, tgt_pos, radii,
                                 group=None):
    """ERP render of one view with the shells split over the ranks of
    group (JAX render_equirect_view_sharded): rgba_layers [H, W, P, 4] (P
    divisible by the ranks), tgt_pose [4, 4], tgt_pos [3], radii [P] ->
    [H, W, 3] float32 on every rank. The gather route: each rank samples
    its block at intersect_sphere's lookups and composites it."""
    h, w, p, _ = rgba_layers.shape
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    p0, p1 = shell_blocks(p, world)[rank]
    rgba = rgba_layers[:, :, p0:p1].float()
    if p0 == 0:       # a_0 := 1 before the gather, as the JAX function
        rgba = rgba.clone()
        rgba[:, :, 0, 3] = 1.0
    uv = intersect.intersect_sphere(tgt_pose, tgt_pos, radii[p0:p1], w, h)
    proj = resample_layers(rgba.permute(2, 0, 1, 3), uv)     # [P/n, H, W, 4]
    c, t = partial_composite(proj.permute(1, 2, 0, 3))
    cg, tg = gather_partials((c, t), group)
    return combine_partials(cg, tg)
