"""Identity-pose dual-eye ODS sweep: the kernel wrapper, its plain version
(row parameters, then the taps) and the row-parameter instrument.

Counterpart of `matryodshka_tpu/ops/pallas_sweep.py` (`_row_params`,
`_ods_sweep_dual_stack`, `ods_sweep_identity_planar`). The kernel is
`csrc/sweep.cu`, which replaces `pallas_sweep._sweep_kernel` and the row
parameters beside it: it projects its own rows (`csrc/project.cuh`), so a
sweep is one launch; its source note gives the bound and the design. The
output is the net's input, channels first and unflipped:
[B, 2*P*3, H, W], channel (eye*P + p)*3 + c.

`sweep_assembled` is the sweep's assembled mode (`csrc/sweep_assembled.cu`,
sharing K1's staged windows through `csrc/sweep_window.cuh`): for the
high-res re-render it writes the interleaved layer stack [B, P', H, W, 4]
that the layer-stack render reads, both eyes' samples blended by the
scheme's rule with the upsampled low-res weights, in one launch; its plain
version `sweep_assembled_plain` is the sweep, upsample and assembly it
stands in for.

`sweep_volume` is also the custom op `matry::sweep_volume`
(`torch.ops.matry.sweep_volume`), so that a program exported with
`torch.export` can carry K1 (`cli/export.py`, the full pipeline). The op
is registered in C++ (`csrc/sweep_op.cpp`: a CUDA implementation that is
one launch of the same kernel, a CPU one that is this module's plain route
transcribed into ATen, and a Meta one for `torch.export`), in the library
`_build.op_library()` builds; `sweep_volume_op` loads it at its first call.
A process that loads an exported program loads that library alone.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch import trace
from matryodshka_tpu_torch.geometry import cameras, grids
from matryodshka_tpu_torch.ops import _build

#: Launches of the sweep kernel in this process, of the row-parameter
#: instrument (sweep_row_params) and of the assembled mode
#: (sweep_assembled).
launches = 0
row_params_launches = 0
assembled_launches = 0

#: The assembled mode's colour rules (cli/test.py:HRES_ASSEMBLY's values)
#: and their codes in csrc/sweep_assembled.cu.
RULES = {"alpha_only": 0, "blend_psv": 1, "blend_bg": 2}


def _probe_columns(width: int):
    """Columns at which the exact projection is evaluated per row: the four
    quarter columns first, then twelve more spread ones."""
    cols = [0, width // 4, width // 2, (3 * width) // 4]
    cols += [(2 * k + 1) * width // 8 for k in range(4)]
    cols += [(2 * k + 1) * width // 16 for k in range(8)]
    return list(dict.fromkeys(c % width for c in cols))


def row_params(order: int, depths, intrinsics, height: int, width: int):
    """Per-(plane, row) sweep parameters, each [P, H].

    v and u0 come from cameras.project_ods at a few probe columns, taking
    the first column that is not parked at (1, 1): f32 cancellation in the
    tangent quadratic can park single pixels of a valid row ("park-flip
    noise"), and u0 = u(c) + c (mod W) holds at any column c. Validity is
    the analytic rho = depth * cos(lat) >= r. Returns int32 y0, y1, x0
    (vertical taps and the horizontal base: column j samples
    x0 - j (mod W) and the next one), fy, fx in depths' dtype (float64
    inputs give the float64 reference the kernel's projection is held
    against), and int32 valid.
    """
    S, T = grids.lat_long_grid((height, width), device=depths.device,
                               dtype=depths.dtype)
    cols = _probe_columns(width)
    pts = cameras.backproject_spherical(S[:, cols], T[:, cols], depths)
    uv = cameras.project_ods(pts, order, intrinsics, width, height)
    uc, vc = uv[..., 0], uv[..., 1]
    parked = (uc == 1.0) & (vc == 1.0)
    colv = torch.tensor(cols, dtype=uc.dtype, device=uc.device)
    u0c = torch.remainder(uc + colv, width)
    idx = torch.argmax((~parked).to(torch.int32), dim=-1, keepdim=True)
    u0 = torch.gather(u0c, -1, idx)[..., 0]
    v = torch.gather(vc, -1, idx)[..., 0]

    rho = depths[:, None] * torch.cos(T[None, :, 0])
    valid = rho >= intrinsics[0, 0]

    y0f = torch.floor(v)
    x0f = torch.floor(u0)
    y0 = torch.remainder(y0f.to(torch.int32), height)
    return {"y0": y0.to(torch.int32),
            "y1": torch.remainder(y0 + 1, height).to(torch.int32),
            "fy": v - y0f,
            "x0": torch.remainder(x0f.to(torch.int32), width).to(torch.int32),
            "fx": u0 - x0f,
            "valid": valid.to(torch.int32)}


def dual_row_params(depths, intrinsics, height: int, width: int):
    """Both eyes' parameters for a batch: intrinsics [B, 3, 3] -> dict of
    [B, 2, P, H] (eye 0 = ref, order +1; eye 1 = src, order -1)."""
    per_b = []
    for k in intrinsics:
        eyes = [row_params(o, depths, k, height, width) for o in (1, -1)]
        per_b.append({n: torch.stack([e[n] for e in eyes]) for n in eyes[0]})
    return {n: torch.stack([d[n] for d in per_b]).contiguous()
            for n in per_b[0]}


def ods_sweep_plain(images, params, out_dtype=torch.float32):
    """Plain version of the kernel. images [B, 2, 3, H, W] float32, params
    from dual_row_params -> [B, 2*P*3, H, W] out_dtype."""
    b, _, c, h, w = images.shape
    p = params["y0"].shape[2]
    j = torch.arange(w, device=images.device)
    xa = torch.remainder(params["x0"].long()[..., None] - j, w)
    xb = torch.remainder(xa + 1, w)
    ya = params["y0"].long()[..., None].expand_as(xa)
    yb = params["y1"].long()[..., None].expand_as(xa)
    flat = images.float().reshape(b, 2, c, h * w)

    def tap(y, x):                                   # -> [B, 2, P, C, H, W]
        idx = (y * w + x).reshape(b, 2, 1, -1).expand(-1, -1, c, -1)
        got = torch.gather(flat, 3, idx).reshape(b, 2, c, p, h, w)
        return got.transpose(2, 3)

    fy = params["fy"][:, :, :, None, :, None]
    fx = params["fx"][:, :, :, None, :, None]
    va = (1.0 - fy) * tap(ya, xa) + fy * tap(yb, xa)
    vb = (1.0 - fy) * tap(ya, xb) + fy * tap(yb, xb)
    out = (1.0 - fx) * va + fx * vb
    park = images[:, :, None, :, 1:2, 1:2].float()   # [B, 2, 1, C, 1, 1]
    valid = params["valid"][:, :, :, None, :, None] > 0
    out = torch.where(valid, out, park)
    return out.reshape(b, 2 * p * c, h, w).to(out_dtype)


def sweep_inputs(ref_image, src_image, depths, intrinsics):
    """The plain version's operands from preprocessed images
    ([B, H, W, 3] in [-1, 1]): (images [B, 2, 3, H, W] float32,
    dual_row_params)."""
    _, h, w, _ = ref_image.shape
    images = torch.stack([ref_image, src_image], dim=1)     # [B, 2, H, W, 3]
    images = images.permute(0, 1, 4, 2, 3).float().contiguous()
    return images, dual_row_params(depths, intrinsics, h, w)


def sweep_volume(ref_image, src_image, depths, intrinsics,
                 out_dtype=torch.float32):
    """Both eyes' identity-pose sweeps of a batch -> the net input
    [B, 2*P*3, H, W] in out_dtype.

    ref_image, src_image: the batch's images [B, H, W, 3] float32 in
    [0, 1], preprocessed (2x - 1) here; depths [P]; intrinsics [B, 3, 3]
    (r = [b, 0, 0]). CPU tensors take the plain route (dual_row_params,
    ods_sweep_plain); CUDA tensors one launch of the kernel, which computes
    its own row parameters; any other device raises."""
    if ref_image.device.type == "cpu":
        images, params = sweep_inputs(_preprocess(ref_image),
                                      _preprocess(src_image), depths,
                                      intrinsics)
        return ods_sweep_plain(images, params, out_dtype)
    global launches
    req = _build.require
    dev = ref_image.device
    req(ref_image.is_cuda, f"sweep_volume: unsupported device {dev}")
    b, h, w, _ = ref_image.shape
    p = depths.shape[0]
    for name, t in (("ref_image", ref_image), ("src_image", src_image)):
        req(t.device == dev and t.dtype == torch.float32
            and t.is_contiguous() and tuple(t.shape) == (b, h, w, 3),
            f"sweep_volume: {name} {t.dtype} {tuple(t.shape)} (contiguous "
            f"float32 [B, H, W, 3])")
    req(w % 8 == 0, f"sweep_volume: width {w} is not a multiple of 8")
    _check_geometry("sweep_volume", depths, intrinsics, b, dev)
    req(out_dtype in (torch.float32, torch.bfloat16),
        f"sweep_volume: out_dtype {out_dtype}")
    lat, lon = grids.lat_long_vectors(h, w, dev)
    out = torch.empty((b, 2 * p * 3, h, w), dtype=out_dtype, device=dev)
    _build.launch(
        "matry_sweep", ref_image.data_ptr(), src_image.data_ptr(),
        depths.data_ptr(), intrinsics.data_ptr(), lat.data_ptr(),
        lon.data_ptr(), out.data_ptr(), b, p, h, w,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
    launches += 1
    return out


def sweep_assembled_plain(hres_ref, hres_src, depths, intrinsics, alphas,
                          blend=None, bg_rgb=None, rule="blend_psv",
                          p0: int = 0, out_dtype=torch.float32,
                          row_params=None):
    """Plain version of the assembled mode: the composition the high-res
    re-render ran before the mode existed, kept in float32 and rounded once
    to out_dtype: sweep_inputs + ods_sweep_plain, the align-corners
    upsample of the low-res arrays (models/msi.py:
    upsample_align_corners_cf) and the high-res assembly (models/msi.py:
    assemble_hres_prepared). Arguments as sweep_assembled's; row_params
    (dual_row_params' tables of these depths, e.g. the kernel's own from
    sweep_row_params) replaces the plain row parameters."""
    from matryodshka_tpu_torch.models import msi as msi_lib
    _, hh, hw, _ = hres_ref.shape
    p = depths.shape[0]
    images, params = sweep_inputs(_preprocess(hres_ref),
                                  _preprocess(hres_src), depths, intrinsics)
    vol = ods_sweep_plain(images, params if row_params is None
                          else row_params, torch.float32)

    def up(x):
        return msi_lib.upsample_align_corners_cf(x.permute(0, 3, 1, 2), hh,
                                                 hw)

    u_blend = None if rule == "alpha_only" else up(blend[..., p0:p0 + p])
    u_bg = up(bg_rgb) if rule == "blend_bg" else None
    stack = msi_lib.assemble_hres_prepared(
        rule, u_blend, up(alphas[..., p0:p0 + p]), vol, u_bg_rgb=u_bg,
        dtype=torch.float32)
    return stack.to(out_dtype)


def sweep_assembled(hres_ref, hres_src, depths, intrinsics, alphas,
                    blend=None, bg_rgb=None, rule="blend_psv", p0: int = 0,
                    out_dtype=torch.float32):
    """The high-res layer stack of shells p0 .. p0+P'-1 straight from the
    batch's image pair: the assembled mode of the sweep
    (csrc/sweep_assembled.cu), what the high-res re-render's shell block
    computed as a sweep, an upsample and an assembly.

    hres_ref, hres_src: [B, Hh, Wh, 3] float32 in [0, 1]; depths [P'] (the
    block's shells); intrinsics [B, 3, 3]; alphas and blend [B, h, w, P]
    float32, the low-res prediction of every shell (blend None for
    alpha_only), read at planes p0 .. p0+P'-1; bg_rgb [B, h, w, 3]
    (blend_bg only); rule one of RULES: alpha_only (fg), blend_psv
    (w fg + (1 - w) bg) or blend_bg (w fg + (1 - w) up(bg_rgb)), fg and
    bg the ref and src eyes' sweeps. -> the interleaved stack
    [B, P', Hh, Wh, 4] in out_dtype (r, g, b, alpha), blended in float32
    and rounded once. CPU tensors take the plain route
    (sweep_assembled_plain); CUDA tensors one launch of the kernel, which
    computes its own row parameters and upsamples in registers; any other
    device raises."""
    global assembled_launches
    with trace.span("sweep.sweep_assembled"):
        if hres_ref.device.type == "cpu":
            return sweep_assembled_plain(hres_ref, hres_src, depths,
                                         intrinsics, alphas, blend, bg_rgb,
                                         rule, p0, out_dtype)
        req = _build.require
        dev = hres_ref.device
        req(hres_ref.is_cuda, f"sweep_assembled: unsupported device {dev}")
        b, hh, hw, _ = hres_ref.shape
        p = depths.shape[0]
        req(rule in RULES, f"sweep_assembled: rule {rule!r} (one of "
                           f"{sorted(RULES)})")
        for name, t in (("hres_ref", hres_ref), ("hres_src", hres_src)):
            req(t.device == dev and t.dtype == torch.float32
                and t.is_contiguous() and tuple(t.shape) == (b, hh, hw, 3),
                f"sweep_assembled: {name} {t.dtype} {tuple(t.shape)} "
                f"(contiguous float32 [B, H, W, 3])")
        req(hw % 4 == 0, f"sweep_assembled: width {hw} is not a multiple of 4")
        _check_geometry("sweep_assembled", depths, intrinsics, b, dev)
        _, h, w, p_low = alphas.shape
        low = []
        for name, t, c, read in (("alphas", alphas, p_low, True),
                                 ("blend", blend, p_low, rule != "alpha_only"),
                                 ("bg_rgb", bg_rgb, 3, rule == "blend_bg")):
            req(not read or (t is not None and t.device == dev
                             and t.dtype == torch.float32 and t.is_contiguous()
                             and tuple(t.shape) == (b, h, w, c)),
                f"sweep_assembled: rule {rule} reads {name} as a contiguous "
                f"float32 [{b}, {h}, {w}, {c}]; got "
                f"{None if t is None else (t.dtype, tuple(t.shape))}")
            low.append(t.data_ptr() if read else None)
        req(h <= hh and w <= hw and 0 <= p0 and p0 + p <= p_low,
            f"sweep_assembled: low-res {h}x{w} into {hh}x{hw}, shells "
            f"{p0}..{p0 + p - 1} of {p_low}")
        req(out_dtype in (torch.float32, torch.bfloat16),
            f"sweep_assembled: out_dtype {out_dtype}")
        lat, lon = grids.lat_long_vectors(hh, hw, dev)
        out = torch.empty((b, p, hh, hw, 4), dtype=out_dtype, device=dev)
        _build.launch(
            "matry_sweep_assembled", hres_ref.data_ptr(), hres_src.data_ptr(),
            depths.data_ptr(), intrinsics.data_ptr(), lat.data_ptr(),
            lon.data_ptr(), *low,
            out.data_ptr(), b, p, hh, hw, h, w, p_low, p0, RULES[rule],
            int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
        assembled_launches += 1
        return out


#: The custom op that carries sweep_volume into exported programs.
OP_NAME = "matry::sweep_volume"


def _op_registered() -> bool:
    try:
        torch.ops.matry.sweep_volume
    except (AttributeError, RuntimeError):
        return False
    return True


def load_op_library() -> None:
    """Register matry::sweep_volume in this process by loading the op
    library (built on first use), unless a loaded library registered it
    already: a second registration of the op is an error."""
    if not _op_registered():
        torch.ops.load_library(str(_build.op_library()))


def sweep_volume_op(ref_image, src_image, depths, intrinsics, out_dtype):
    """sweep_volume through the registered op: on CUDA tensors one launch
    of the kernel (counted by the library, op_launches), on CPU tensors
    the plain route in ATen, equal to sweep_volume's bit for bit."""
    load_op_library()
    return torch.ops.matry.sweep_volume(ref_image, src_image, depths,
                                        intrinsics, out_dtype)


def op_launches() -> int:
    """The op library's launches of the kernel in this process."""
    load_op_library()
    return torch.ops.matry.sweep_volume_launches()


def sweep_row_params(depths, intrinsics, height: int, width: int):
    """The row parameters the sweep kernel computes, as dual_row_params'
    tables ([B, 2, P, H] each): an instrument that lets the projection
    and the sweep be checked apart. CPU tensors: dual_row_params; CUDA
    tensors: one launch of the kernel's own projection
    (csrc/sweep.cu:matry_sweep_row_params)."""
    if depths.device.type == "cpu":
        return dual_row_params(depths, intrinsics, height, width)
    global row_params_launches
    dev = depths.device
    _build.require(depths.is_cuda,
                   f"sweep_row_params: unsupported device {dev}")
    b, p = intrinsics.shape[0], depths.shape[0]
    _check_geometry("sweep_row_params", depths, intrinsics, b, dev)
    lat, lon = grids.lat_long_vectors(height, width, dev)
    out = {n: torch.empty((b, 2, p, height),
                          dtype=torch.float32 if n in ("fy", "fx")
                          else torch.int32, device=dev)
           for n in ("y0", "y1", "fy", "x0", "fx", "valid")}
    _build.launch(
        "matry_sweep_row_params", depths.data_ptr(), intrinsics.data_ptr(),
        lat.data_ptr(), lon.data_ptr(),
        *(t.data_ptr() for t in out.values()), b, p, height, width,
        _build.stream_ptr(dev))
    row_params_launches += 1
    return out


def _preprocess(image):
    """models/msi.py:preprocess_image: [0, 1] -> [-1, 1]."""
    return image * 2.0 - 1.0


def _check_geometry(what, depths, intrinsics, b, dev):
    req = _build.require
    req(depths.device == dev and depths.dtype == torch.float32
        and depths.dim() == 1 and depths.is_contiguous(),
        f"{what}: depths {depths.dtype} {tuple(depths.shape)}")
    req(intrinsics.device == dev and intrinsics.dtype == torch.float32
        and intrinsics.is_contiguous()
        and tuple(intrinsics.shape) == (b, 3, 3),
        f"{what}: intrinsics {intrinsics.dtype} "
        f"{tuple(intrinsics.shape)}")


def row_params_error(got, ref, depths, height: int, width: int):
    """How far row parameters `got` place the sweep's samples from `ref`
    (dual_row_params-shaped dicts; ref is typically the float64
    evaluation): (validity equal, grids.lookup_error over ref's valid
    rows, u = x0 + fx, v = y0 + fy, each row at its plane's depth)."""
    valid = ref["valid"] > 0
    same = bool(torch.equal(got["valid"] > 0, valid))

    def pos(d, i, f):
        return (d[i].double() + d[f].double())[valid]

    scale = depths.double()[None, None, :, None].expand(valid.shape)
    return same, grids.lookup_error(
        pos(got, "x0", "fx"), pos(got, "y0", "fy"), pos(ref, "x0", "fx"),
        pos(ref, "y0", "fy"), scale.to(valid.device)[valid], height, width)
