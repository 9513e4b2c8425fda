"""The graph-convolution MSI head on an icosphere (Pixel2Mesh-derived).

Counterpart of `matryodshka_tpu/models/gcn.py` (the reference's gcn_net,
matryodshka/nets.py:722-732): 14 graph convolutions, in -> ngf, 12 x
ngf -> ngf (ReLU), ngf -> out (tanh), where each layer computes
sum_i support_i @ (x @ W_i) + b over the 2-support stack
[I, D^-1/2 A D^-1/2] (geometry/icosphere.py).

The sparse support product is a gather and an `index_add_` over the COO
edge list, the JAX package's segment-sum; the JAX package has no TPU
kernel here (XLA lowers it), so the port uses PyTorch's ops, on the card
as on the CPU.

Parameters keep the flax tree's names and values: layer `conv1_1` holds
`weights_0`, `weights_1` [in, out] and `bias` [out]. flax stores each
weight uncentred, drawn uniform in [0, 2r) with r = sqrt(6 / (in + out))
(Glorot), and the forward uses W - r (JAX gcn.py:62-66); so does this
module: the parameter is the stored value and `forward` subtracts r, so
the flax bridge (weights.gcn_from_flax / gcn_to_flax) copies values
unchanged, bit for bit both ways, and the gradient with respect to the
stored value is the JAX one.

`mesh_to_equirect` scatters per-vertex values onto the ERP grid through
the barycentric p2v table in the reference's transposed [W, H, 3, 2]
layout (projector.py:293-332).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

#: The head's hidden layers after conv1_1 (conv2_0 .. conv2_11).
HIDDEN = 12


class SparseSupport(nn.Module):
    """A COO sparse matrix [V, V] with a gather / index_add product. Its
    index and value tensors are buffers (moved with the module, not in
    its state_dict). is_identity is decided on the host when the support
    is made, as the JAX class does, so the identity support costs no
    product."""

    def __init__(self, rows, cols, vals, num_verts: int):
        super().__init__()
        rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
        self.is_identity = bool(
            rows.shape[0] == num_verts and np.array_equal(rows, cols)
            and np.allclose(vals, 1.0))
        self.num_verts = num_verts
        self.register_buffer("rows", torch.as_tensor(rows, dtype=torch.long),
                             persistent=False)
        self.register_buffer("cols", torch.as_tensor(cols, dtype=torch.long),
                             persistent=False)
        self.register_buffer("vals", torch.as_tensor(vals,
                                                     dtype=torch.float32),
                             persistent=False)

    def matmul(self, x):
        """[V, F] -> [V, F]: out[rows[e]] += vals[e] * x[cols[e]]."""
        gathered = x.index_select(0, self.cols) * self.vals[:, None]
        out = x.new_zeros((self.num_verts, x.shape[1]))
        return out.index_add(0, self.rows, gathered)


class GraphConv(nn.Module):
    """One graph conv: sum_i support_i @ (x @ (W_i - r)) + b (nets.py:
    650-679), with the flax layer's parameters (module docstring)."""

    def __init__(self, input_dim: int, output_dim: int, num_supports: int,
                 use_bias: bool = True):
        super().__init__()
        # r in float32, as the JAX forward's W - r computes it
        self.init_range = float(np.float32(glorot_range(input_dim,
                                                        output_dim)))
        for i in range(num_supports):
            self.register_parameter(f"weights_{i}", nn.Parameter(
                torch.zeros(input_dim, output_dim)))
        self.bias = (nn.Parameter(torch.zeros(output_dim)) if use_bias
                     else None)

    def forward(self, x, supports: Sequence[SparseSupport]):
        out = None
        for i, support in enumerate(supports):
            pre = x @ (getattr(self, f"weights_{i}") - self.init_range)
            if not support.is_identity:
                pre = support.matmul(pre)
            out = pre if out is None else out + pre
        if self.bias is not None:
            out = out + self.bias
        return out


class GCNNet(nn.Module):
    """The 14-layer MSI GCN head (nets.py:722-732): [V, num_inputs]
    float32 -> [V, num_outputs] in (-1, 1); the layers of layer_shapes,
    ReLU after each but the last, tanh after it."""

    def __init__(self, num_inputs: int, num_outputs: int,
                 supports: Sequence[SparseSupport], ngf: int = 64):
        super().__init__()
        self.supports = nn.ModuleList(supports)
        self.names = []
        for name, cin, cout in layer_shapes(num_inputs, num_outputs, ngf):
            setattr(self, name, GraphConv(cin, cout, len(supports)))
            self.names.append(name)

    def forward(self, x):
        sup = list(self.supports)
        x = x.float()
        for name in self.names[:-1]:
            x = torch.relu(getattr(self, name)(x, sup))
        return torch.tanh(getattr(self, self.names[-1])(x, sup))


def layer_shapes(num_inputs: int, num_outputs: int, ngf: int):
    """[(name, input_dim, output_dim)] of GCNNet's layers, in order: the
    flax tree's conv1_1, conv2_0 .. conv2_11, conv3_1."""
    return ([("conv1_1", num_inputs, ngf)]
            + [(f"conv2_{i}", ngf, ngf) for i in range(HIDDEN)]
            + [("conv3_1", ngf, num_outputs)])


def mesh_to_equirect(mesh_colors, p2v):
    """Barycentric scatter of per-vertex values to the ERP image.

    mesh_colors [V, C]; p2v [W, H, 3, 2] (vertex id, weight) pairs, the
    reference layout. Returns [1, H, W, C] (projector.py:293-332, its
    transposed table included)."""
    w, h = p2v.shape[0], p2v.shape[1]
    ids = p2v[..., 0].long().reshape(-1, 3)
    wts = p2v[..., 1].reshape(-1, 3)
    vals = mesh_colors[ids]                                  # [W*H, 3, C]
    out = torch.sum(vals * wts[..., None], dim=1)            # [W*H, C]
    return out.reshape(1, w, h, -1).permute(0, 2, 1, 3)


def glorot_range(input_dim: int, output_dim: int) -> float:
    """r of a layer's uniform [0, 2r) init and of its W - r."""
    return math.sqrt(6.0 / (input_dim + output_dim))
