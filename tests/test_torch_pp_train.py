"""The port's PP and REALESTATE_PP inference and train step against the JAX
package's, on CPU, float32, 32x64, 4 planes, ngf 8, weights from the flax
tree (`weights.from_flax`), numpy inputs from seeds.

The JAX package's `perspective_plane_sweep` applies its pose twice (see
tests/test_torch_homography.py); here the JAX side runs with it replaced
by `jax_pp_sweep_once`, the JAX package's own functions composed with the
pose applied once, which is what the port computes. REALESTATE_PP needs no
such replacement.

* The plain `infer_msi` + `render_mpi_view` and the test CLI's kernel
  route (`msi.infer_mpi`: sweep_stage, the net's stages through the conv
  and layer-norm wrappers, which run their plain versions on CPU tensors)
  against JAX `infer_msi` + `render_mpi_view`: 1e-4 on the [-1, 1] view
  (float32 through 18 layers in other summation orders, then the warps).
* One train step's total, reconstruction and enforcement losses (rtol
  1e-5) and every parameter gradient (1e-4 of a leaf's largest,
  test_torch_train.py's `_assert_grads_close`) against
  `jax.value_and_grad(make_loss_fn(...))`, with the pixel loss, E-LPIPS
  (JAX's recorded draws replayed, tests/test_torch_transform_inverse.py)
  and transform_inverse_reg (JAX's jitter pose replayed through the
  loss's `jitter_pose`), on the wrap net (the trainer's K7 route) and the
  coord net. Both sides take the JAX sweep's net input (the port's loss
  through its `sweep` and `sweep_jitter`), as tests/test_torch_train.py
  does: the sweeps are held to each other above and in
  tests/test_torch_homography.py, while these gradients are
  ill-conditioned in the net input on this tiny random net: in the
  regularized wrap-net case, jittered inputs 1.5e-5 apart (the jitter
  pose inverted by numpy instead of jnp) move the port's own conv4_2
  weight gradient by 4% of its largest and conv1_1's bias gradient by
  1.6e-3; with the same input every leaf agrees within 7.5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.geometry import cameras as tcam
from matryodshka_tpu_torch.losses.elpips import api as tapi
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.training import step as tstep
from test_torch_homography import (jax_pp_sweep_once, pp_intrinsics,
                                   random_pose, re_intrinsics)
from test_torch_train import TINY, _assert_grads_close, _torch_net
from test_torch_transform_inverse import (RNG, SCALE_SWAP, elpips_pair,
                                          jax_jitter_pose)
from test_torch_elpips import port_draws

torch.set_num_threads(1)
assert elpips_pair  # the shared fixture, used by name below

INFER_TOL = 1e-4
#: (input_type, coord_net, which_loss, transform_inverse_reg) per case:
#: each input type with the pixel loss on the wrap net (the trainer's K7
#: route), and with E-LPIPS and the regularizer on the coord net (the
#: recipes' net).
CASES = {"pp_pixel_wrap": ("PP", False, "pixel", False),
         "pp_elpips_reg_coord": ("PP", True, "elpips", True),
         "re_pixel_wrap": ("REALESTATE_PP", False, "pixel", False),
         "re_elpips_reg_coord": ("REALESTATE_PP", True, "elpips", True)}


@pytest.fixture(autouse=True)
def pose_once(monkeypatch):
    monkeypatch.setattr(jsweep, "perspective_plane_sweep", jax_pp_sweep_once)


def numpy_batch(input_type, seed=0):
    """A batch as the loaders give it: PP (ref I, src and tgt x offsets,
    the slerp midpoint's inverse as ref_pose_inv, the PP K) or RealEstate
    (random small poses, a RealEstate K, ref_pose_inv = inv(ref_pose))."""
    rng = np.random.RandomState(seed)
    h, w = TINY["height"], TINY["width"]
    imgs = {k: rng.rand(1, h, w, 3).astype(np.float32)
            for k in ("ref_image", "src_image", "tgt_image")}
    if input_type == "PP":
        ref = np.eye(4, dtype=np.float32)[None]
        src, tgt = ref.copy(), ref.copy()
        src[0, 0, 3], tgt[0, 0, 3] = -0.1, -0.05
        interp = tcam.interpolate_pose(torch.from_numpy(ref[0]),
                                       torch.from_numpy(src[0])).numpy()
        return dict(imgs, ref_pose=ref, src_pose=src, tgt_pose=tgt,
                    intrinsics=pp_intrinsics(h, w)[None],
                    ref_pose_inv=np.linalg.inv(interp)[None])
    ref, src, tgt = (random_pose(rng, 0.05, 0.1)[None] for _ in range(3))
    return dict(imgs, ref_pose=ref, src_pose=src, tgt_pose=tgt,
                intrinsics=re_intrinsics(h, w)[None],
                ref_pose_inv=np.linalg.inv(ref))


def setup(input_type, **kw):
    """(JAX config, port config, flax state, JAX model, numpy batch)."""
    jcfg = JaxConfig(**TINY, input_type=input_type, **kw).validate()
    tcfg = MatryConfig(**TINY, input_type=input_type, **kw).validate()
    state, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, state, model, numpy_batch(input_type)


def _depths(n):
    return np.asarray(jsweep.inv_depths(1.0, 100.0, n), np.float32)


def jax_net_input(jcfg, batch, jitter_pose=None):
    """The JAX package's net input of the batch [B, C, H, W] as a tensor
    (the pose-once perspective sweep for PP), at the jitter pose [4, 4]
    inverted as the JAX loss inverts it."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, src = (jmsi.preprocess_image(b[k]) for k in ("ref_image",
                                                       "src_image"))
    d = jnp.asarray(_depths(jcfg.num_psv_planes))
    j = None if jitter_pose is None else jnp.linalg.inv(
        jnp.asarray(jitter_pose))[None]
    if jcfg.input_type == "REALESTATE_PP":
        vol = jsweep.format_realestate_network_input(
            ref, src, b["ref_pose"], b["src_pose"], d, b["intrinsics"],
            jitter_pose_inv=j)
    else:
        vol = jsweep.format_network_input(
            ref, src, b["ref_pose"], b["src_pose"], b["ref_pose_inv"], d,
            b["intrinsics"], input_type=jcfg.input_type, jitter_pose_inv=j)
    return torch.from_numpy(np.asarray(vol)).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(request, name):
    input_type, coord, loss, reg = CASES[name]
    jcfg, tcfg, state, model, batch = setup(
        input_type, coord_net=coord, which_loss=loss,
        transform_inverse_reg=reg)
    captured, elpips = [], None
    elpips_fn = None
    if loss == "elpips":
        metric, path = request.getfixturevalue("elpips_pair")

        def elpips_fn(p, t, rng):
            d, draws = metric(p, t, rng)
            captured.append(draws)
            return d
    loss_fn = jstep.make_loss_fn(jcfg, model.apply, elpips_fn)

    def loss_with_draws(params, b, rng):
        captured.clear()
        total, aux = loss_fn(params, b, rng)
        return total, (aux, list(captured))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (jaux, draws)), jgrads = jax.value_and_grad(
        loss_with_draws, has_aux=True)(state.params, jb, RNG)
    if loss == "elpips":
        assert len(draws) == 1 + reg
        tm = tapi.Metric(tapi.elpips_vgg(batch_size=1), weight_path=path)
        replay = iter([port_draws(d, swap=SCALE_SWAP[1]) for d in draws])
        elpips = lambda p, t, g: tm(p, t, draws=next(replay))  # noqa: E731
    net = _torch_net(tcfg, state.params)
    vol = jax_net_input(jcfg, batch)
    tloss = tstep.make_loss_fn(tcfg, net, sweep=lambda c, b, d: vol,
                               elpips=elpips)
    pose = None
    if reg:
        pose = np.array(jax_jitter_pose(jcfg, RNG))
        vol_j = jax_net_input(jcfg, batch, pose)
        tloss.sweep_jitter = lambda b, p: vol_j
        pose = torch.from_numpy(pose)
    total, aux = tloss({k: torch.from_numpy(v) for k, v in batch.items()},
                       jitter_pose=pose)
    total.backward()
    assert aux["output_image"].shape == (1, 32, 64, 3)
    keys = ["total_loss", "reconstruction_loss"] + (
        ["enforcement_loss"] if reg else [])
    assert set(tstep.scalar_metrics(aux)) == set(keys)
    for k in keys:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    if reg:
        assert float(aux["enforcement_loss"]) > 0
    _assert_grads_close(net, jgrads["params"], 1e-4)


@pytest.mark.parametrize("input_type,coord", [("PP", False),
                                              ("REALESTATE_PP", True)])
def test_infer_and_mpi_render_match_jax(input_type, coord):
    jcfg, tcfg, state, model, batch = setup(input_type, coord_net=coord)
    d = _depths(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jmsi.infer_msi(lambda p, x: model.apply(p, x), state.params, jcfg,
                         jb, jnp.asarray(d))
    rel = jnp.einsum("bij,bjk->bik", jb["tgt_pose"], jb["ref_pose_inv"])
    want = np.asarray(jmsi.render_mpi_view(out["rgba_layers"], rel,
                                           jnp.asarray(d), jb["intrinsics"]))
    assert out["psv"].shape[-1] == tcfg.num_net_inputs()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = entry.make_params(tcfg, flax_params=jax.tree.map(
        np.asarray, state.params), device="cpu")
    with torch.no_grad():
        plain = tmsi.infer_msi(params.net, tcfg, tb, params.psv_depths)
        np.testing.assert_allclose(plain["rgba_layers"].numpy(),
                                   np.asarray(out["rgba_layers"]), rtol=0,
                                   atol=INFER_TOL)
        got_plain = tmsi.render_mpi_view(
            plain["rgba_layers"], tmsi.mpi_view_pose(tb), params.msi_depths,
            tb["intrinsics"])
        kernel = tmsi.infer_mpi(tcfg, params.stages, tb, params.psv_depths,
                                params.msi_depths)
    for got in (got_plain, kernel["output_image"]):
        assert got.shape == (1, 32, 64, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=INFER_TOL)


def test_train_step_routes_and_counts():
    """The PP train step sweeps by gather (one format_network_input per
    forward, two with the regularizer) and never calls the identity-pose
    sweep kernel's wrapper; supervision src/ref is not reached for PP and
    validates, as in the JAX trainer, and for ODS validates too (its eye
    re-render terms)."""
    from matryodshka_tpu_torch.geometry import sweep as tsweep
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.training import state as tstate
    _, tcfg, state, _, batch = setup("PP", transform_inverse_reg=True)
    ts = tstate.init_state(tcfg, 0, "cpu")
    before = (tsweep.gather_sweeps, sweep_ops.launches)
    _, m = tstep.make_train_step(tcfg, ts.net)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert (tsweep.gather_sweeps, sweep_ops.launches) == (before[0] + 2,
                                                          before[1])
    assert np.isfinite(float(m["enforcement_loss"]))
    MatryConfig(**TINY, input_type="PP", supervision="tgt_src").validate()
    cfg = MatryConfig(**TINY, supervision="tgt_src").validate()
    assert cfg.supervise_src and not cfg.supervise_ref
