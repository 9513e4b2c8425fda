"""The sweep's assembled mode (ops/sweep.py:sweep_assembled, the plain
version of csrc/sweep_assembled.cu) against the JAX package's high-res
route, on CPU, and the kernel's tile arithmetic emulated in numpy.

The JAX route is build_hres_render_fn_fused's: the row-chunked Pallas
sweep ods_sweep_identity_chunked (interpret mode) of the preprocessed
pair, the align-corners upsample of the low-res weights, alphas and
background colour, and assemble_hres_prepared, whose W-flipped, row-padded
planar stack is compared with the port's interleaved one permuted to
[P, 4, H, W] (prepared[:, :, pad:pad+H, ::-1]). Inputs: numpy from a seed,
low-res 64x128 into high-res 128x256, 4 shells (1 m to 100 m), the whole
stack and a block of its last two shells, each of the three colour rules,
float32.

Bounds: sweep_assembled_plain makes its own row parameters
(ops/sweep.py:row_params), whose f32 position noise (<= 4e-3 px on the
100 m shell, tests/test_torch_sweep.py) times an image slope of at most 2
per pixel bounds a colour's difference by 1e-2 (max) and 1e-4 (mean), K1's
parity bounds (test_sweep_volume_matches_pallas_k1); the upsample's two
implementations differ by ~1e-6 (test_upsample_align_corners_matches_jax).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.ops import pallas_render, pallas_sweep
from matryodshka_tpu_torch.cli import test as cli_test
from matryodshka_tpu_torch.ops import sweep as sweep_ops

torch.set_num_threads(1)

h, w, HH, HW, P = 64, 128, 128, 256, 4
RULES = ["alpha_only", "blend_psv", "blend_bg"]
BLOCKS = [(0, P), (2, P)]
CAP, CAP_PAD, KV = pallas_render.CAP_ROWS, 16, 7


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref, src = rng.rand(2, 1, HH, HW, 3).astype(np.float32)
    alphas, blend = rng.rand(2, 1, h, w, P).astype(np.float32)
    bg_rgb = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    intr = np.eye(3, dtype=np.float32)[None].copy()
    intr[:, 0, 0] = 0.032
    return ref, src, alphas, blend, bg_rgb, depths, intr


@functools.lru_cache(maxsize=None)
def _jax_sweep(p0, p1):
    """K1's row-chunked high-res sweep of shells p0 .. p1-1 (flipped
    planar fgF, bgF [1, P', 3, HH, HW])."""
    ref, src, _, _, _, depths, intr = _inputs()
    return pallas_sweep.ods_sweep_identity_chunked(
        jmsi.preprocess_image(jnp.asarray(ref)),
        jmsi.preprocess_image(jnp.asarray(src)), jnp.asarray(depths[p0:p1]),
        jnp.asarray(intr), chunk_rows=32, interpret=True)


def _jax_stack(rule, p0, p1):
    """The JAX high-res prepared stack of shells p0 .. p1-1, unflipped and
    unpadded: [P', 4, HH, HW] float32."""
    _, _, alphas, blend, bg_rgb, _, _ = _inputs()
    fgF, bgF = _jax_sweep(p0, p1)
    up = functools.partial(jmsi.upsample_align_corners, out_h=HH, out_w=HW)
    u_alpha = up(jnp.asarray(alphas[..., p0:p1]))[0]
    u_blend = up(jnp.asarray(blend[..., p0:p1]))[0]
    u_bg = up(jnp.asarray(bg_rgb))[0]
    prep = jmsi.assemble_hres_prepared(
        rule, u_blend, u_alpha, fgF[0], bgF[0], u_bg, CAP,
        pallas_render.ROW_BLOCK, CAP_PAD, KV, dtype=jnp.float32)["prepared"]
    pad = pallas_render._band_geometry(CAP, pallas_render.ROW_BLOCK, KV)[2]
    return np.asarray(prep)[:, :, pad:pad + HH, ::-1]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("rule", RULES)
def test_sweep_assembled_matches_jax(rule, block):
    ref, src, alphas, blend, bg_rgb, depths, intr = (
        torch.from_numpy(x) for x in _inputs())
    p0, p1 = block
    got = sweep_ops.sweep_assembled(
        ref, src, depths[p0:p1], intr, alphas,
        None if rule == "alpha_only" else blend,
        bg_rgb if rule == "blend_bg" else None, rule=rule, p0=p0)
    assert got.shape == (1, p1 - p0, HH, HW, 4)
    assert got.dtype == torch.float32
    err = np.abs(got[0].permute(0, 3, 1, 2).numpy()
                 - _jax_stack(rule, p0, p1))
    assert err.max() < 1e-2, err.max()
    assert err.mean() < 1e-4, err.mean()


@pytest.mark.parametrize("rule", RULES)
def test_sweep_assembled_rounds_once(rule):
    """bf16: the float32 stack rounded once (the kernel's one rounding at
    its store), not a bf16 volume blended and rounded again."""
    ref, src, alphas, blend, bg_rgb, depths, intr = (
        torch.from_numpy(x) for x in _inputs(1))
    args = (ref, src, depths, intr, alphas, blend, bg_rgb, rule)
    got = sweep_ops.sweep_assembled(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, sweep_ops.sweep_assembled(*args).to(
        torch.bfloat16))


@pytest.mark.parametrize("scheme", ["blend_psv", "blend_bg", "blend_bg_psv",
                                    "alpha_only"])
def test_hres_block_is_one_assembled_call(scheme, monkeypatch):
    """build_hres_render_fn takes each shell block's stack from one
    sweep_assembled call with the scheme's rule (HRES_ASSEMBLY), whole and
    in two blocks."""
    from matryodshka_tpu_torch import entry
    cfg = entry.flagship_cfg(height=h // 4, width=w // 4, num_psv_planes=P,
                             num_msi_planes=P, ngf=8, hres_height=h // 2,
                             hres_width=w // 2, which_color_pred=scheme,
                             compute_dtype="float32")
    calls = []
    real = sweep_ops.sweep_assembled

    def counted(*a, **k):
        calls.append((k["rule"], k["p0"], a[2].shape[0]))
        return real(*a, **k)

    monkeypatch.setattr(sweep_ops, "sweep_assembled", counted)
    ref, src, alphas, blend, bg_rgb, _, intr = (
        torch.from_numpy(x) for x in _inputs(2))
    hr = [x[:, :h // 2, :w // 2].contiguous() for x in (ref, src)]
    lo = [x[:, :h // 4, :w // 4] for x in (blend, alphas, bg_rgb)]
    eye = torch.eye(4)[None]
    tgt = torch.tensor([[0.02, -0.01, 0.03]])
    rule = cli_test.HRES_ASSEMBLY[scheme]
    for shards, want in ((1, [(rule, 0, P)]),
                         (2, [(rule, 0, P // 2), (rule, P // 2, P // 2)])):
        calls.clear()
        rgb, depth = cli_test.build_hres_render_fn(cfg, shards)(
            *hr, lo[0], lo[1], eye, eye, eye, intr, tgt, bg_rgb=lo[2])
        assert calls == want
        assert rgb.shape == depth.shape == (1, h // 2, w // 2, 3)


#: csrc/sweep_assembled.cu's tile: output columns a tile and the tile
#: width up to which a tile is the whole row.
TILE_W = 512


def _f32(x):
    return np.float32(x)


@pytest.mark.parametrize("lw,ow", [(640, 4096), (320, 2048), (128, 256),
                                   (64, 128), (640, 640), (160, 1280),
                                   (637, 4096)])
def test_assembled_tile_columns_cover_the_taps(lw, ow):
    """The kernel stages, per tile, low-res columns c_lo .. c_lo+ncols-1
    (ncols = min(ucols, w - c_lo), ucols from the host's bound); every
    output column's two taps (F.interpolate's align-corners source index
    in f32 and the clamped upper tap) must fall among them. Emulates the
    kernel's f32 arithmetic in numpy (IEEE products, as __fmul_rn)."""
    tile_w = min(ow, TILE_W)
    scale_h = (lw - 1) / (ow - 1)
    ucols = min(lw, int(np.ceil((tile_w - 1) * scale_h)) + 3)
    scale = _f32(_f32(lw - 1) / _f32(ow - 1))
    for j0 in range(0, ow, tile_w):
        c_lo = int(_f32(scale * _f32(j0)))
        ncols = min(ucols, lw - c_lo)
        for j in range(j0, min(j0 + tile_w, ow)):
            s = _f32(scale * _f32(j))
            i0 = int(s)
            step = 1 if i0 < lw - 1 else 0
            assert 0 <= i0 - c_lo and i0 - c_lo + step < ncols, (j0, j)
            assert 0.0 <= float(s - _f32(i0)) < 1.0
