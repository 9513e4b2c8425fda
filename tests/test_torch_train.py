"""The port's trainer against the JAX package's, on CPU, float32.

* The K7 route of MSIUNet (ops/wrap_conv.py's plain versions on CPU
  tensors) against the flax MSIUNet with `pallas_interpret=True` (every
  stride-1 conv through the interpret-mode K7c), at test_unet.py:215's
  rtol/atol 2e-3, and its forward and parameter gradients against
  `jax.grad` of the flax MSIUNet with XLA convs.
* The train step's loss and every parameter gradient against
  `jax.value_and_grad(make_loss_fn(...))` for the default config,
  spherical attention + wreg, alpha_only, the coord net and the smoothed
  net (both variants; JAX training/state.py:30 passes smoothed), on
  tests/test_train_smoke.py's tiny config and batch; then parameters after
  Adam steps against JAX's train step.

The JAX package sweeps by gather on the CPU, the port's K1 plain version
with analytic validity, and the two park different far-shell pixels
(ROADMAP Queue 3); so both sides here take the JAX gather sweep's volume
(the port's loss through its `sweep` argument).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.losses import basic as jbasic
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.models import unet as junet
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.losses import basic as tbasic
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.training import state as tstate
from matryodshka_tpu_torch.training import step as tstep

torch.set_num_threads(1)

TINY = dict(height=32, width=64, num_psv_planes=4, num_msi_planes=4,
            ngf=8, batch_size=1, compute_dtype="float32")
CONFIGS = {"default": {},
           "spherical_wreg": dict(spherical_attention=True, wreg=True),
           "alpha_only": dict(which_color_pred="alpha_only"),
           "coord_net": dict(coord_net=True),
           "smoothed": dict(smoothed=True),
           "smoothed_coord": dict(smoothed=True, coord_net=True)}


def _numpy_batch(seed=0):
    """test_train_smoke.py:synthetic_batch, as numpy."""
    rng = np.random.RandomState(seed)
    b, h, w = 1, TINY["height"], TINY["width"]

    def img():
        return rng.rand(b, h, w, 3).astype(np.float32)

    eye = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    intr = np.tile(np.asarray([[0.032, 0, 0], [0, 1, 0], [0, 0, 1.0]],
                              np.float32)[None], (b, 1, 1))
    return {"ref_image": img(), "src_image": img(), "tgt_image": img(),
            "ref_pose": eye, "src_pose": eye, "ref_pose_inv": eye,
            "tgt_pose": np.tile(np.asarray([[0.05, 0.0, 0.0]], np.float32),
                                (b, 1)),
            "intrinsics": intr}


def _setup(**kw):
    """(jax cfg, torch cfg, flax params, numpy batch, the gather sweep's
    volume [B, 2*P*3, H, W] as a sweep function for the port)."""
    jcfg = JaxConfig(**TINY, **kw).validate()
    tcfg = MatryConfig(**TINY, **kw).validate()
    state, _ = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = _numpy_batch()
    depths = jnp.asarray(jsweep.inv_depths(jcfg.min_depth, jcfg.max_depth,
                                           jcfg.num_psv_planes))
    psv = np.asarray(jsweep.format_network_input(
        jmsi.preprocess_image(batch["ref_image"]),
        jmsi.preprocess_image(batch["src_image"]), batch["ref_pose"],
        batch["src_pose"], batch["ref_pose_inv"], depths,
        batch["intrinsics"]))
    vol = torch.from_numpy(psv.copy()).permute(0, 3, 1, 2).contiguous()
    return jcfg, tcfg, state, batch, (lambda cfg, b, d: vol)


def _torch_net(tcfg, params):
    net = tstate.build_model(tcfg)
    net.load_state_dict(weights.from_flax(jax.tree.map(np.asarray, params)))
    return net


def _assert_grads_close(net, jgrads, rtol):
    """Each parameter's gradient within rtol * max|JAX gradient| of the
    JAX one (elementwise), over every leaf of the tree."""
    want = weights.from_flax(jax.tree.map(np.asarray, jgrads))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        tol = rtol * max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max())
        assert err <= tol, (name, err, tol)


# ---------------------------------------------------------------------------
# The K7 route of the net.
# ---------------------------------------------------------------------------

def test_k7_route_matches_pallas_interpret_net():
    """stats_min_cin=0 routes every stride-1 wrap conv through K7c, as
    flax's pallas_interpret=True does (tests/test_unet.py:202-216)."""
    rng = np.random.RandomState(11)
    x = rng.rand(1, 32, 128, 12).astype(np.float32)
    base = junet.MSIUNet(num_outputs=8, ngf=8, variant="wrap",
                         dtype=jnp.float32)
    params = base.init(jax.random.PRNGKey(0), jnp.asarray(x))
    fused = junet.MSIUNet(num_outputs=8, ngf=8, variant="wrap",
                          dtype=jnp.float32, pallas_interpret=True)
    want = np.asarray(fused.apply(params, jnp.asarray(x)))
    net = MSIUNet(12, 8, 8, dtype=torch.float32, wrap_conv_kernel=True,
                  stats_min_cin=0)
    net.load_state_dict(weights.from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("stats_min_cin", [0, 160])
def test_k7_route_grads_match_flax(stats_min_cin):
    """Forward to 5e-5 (tests/test_torch_net.py's bound) and every
    parameter gradient of sum(pred * r) to 1e-4 of its largest magnitude
    against jax.grad of the flax net with XLA convs: float32 sums in other
    orders through 18 layers. stats_min_cin=0: every stride-1 conv through
    K7c (the layer norm from the kernel's sums); 160: K7b at ngf 8."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (1, 32, 64, 24)).astype(np.float32)
    r = rng.randn(1, 32, 64, 8).astype(np.float32)
    model = junet.MSIUNet(num_outputs=8, ngf=8, variant="wrap",
                          dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def loss(p):
        pred = model.apply(p, jnp.asarray(x))
        return jnp.sum(pred * r), pred

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    net = MSIUNet(24, 8, 8, dtype=torch.float32, wrap_conv_kernel=True,
                  stats_min_cin=stats_min_cin)
    net.load_state_dict(weights.from_flax(jax.tree.map(np.asarray, params)))
    pred = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    (pred * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(pred.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=5e-5)
    _assert_grads_close(net, jgrads["params"], 1e-4)


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name):
    """Loss and aux terms to rtol 1e-5 (a 0.5*sum over 6,144 pixel errors
    of float32 renders; 1e-4 with spherical attention, whose latitude map
    JAX forms in float32 and the port in float64: they differ by up to
    ~1e-4 on the rows nearest the equator, where the map is largest),
    every parameter gradient to 1e-4 of its largest magnitude."""
    rtol = 1e-4 if CONFIGS[name].get("spherical_attention") else 1e-5
    jcfg, tcfg, state, batch, sweep = _setup(**CONFIGS[name])
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    loss_fn = jstep.make_loss_fn(jcfg, model.apply)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, jbatch, jax.random.PRNGKey(1))
    net = _torch_net(tcfg, state.params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tstep.make_loss_fn(tcfg, net, sweep=sweep)(tbatch)
    loss.backward()
    aux = tstep.scalar_metrics(aux)
    for k in ("total_loss", "reconstruction_loss", "weight_reg_loss"):
        assert (k in aux) == (k in jaux), k
        if k in aux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=rtol, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    _assert_grads_close(net, jgrads["params"], 1e-4)


def test_adam_steps_match_jax():
    """Two steps of each train step from the same parameters: metrics to
    rtol 1e-4; each parameter element to 1e-2 * lr per step taken, and to
    2 * lr per step only where its gradient was at noise level (below
    1e-6 of its leaf's largest) at a step so far. Adam moves each parameter
    by about lr * sign(grad) at first, so a noise-level gradient (a bias
    component along a layer norm's null direction) may step the other way
    in one package; elsewhere the two updates agree to ~5e-3 * lr (float32
    gradients 1e-5 apart), and a flipped sign or a wrong moment moves them
    by O(lr). The noise mask reads the port's gradients, which the test
    above holds to JAX's. JAX's step runs op by op (the function that
    make_train_step jits): jit lets XLA contract the sweep's projection
    differently, which parks other far-shell pixels than the volume the
    port is given."""
    jcfg, tcfg, state, batch, sweep = _setup()
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    tx = jstate.build_optimizer(jcfg)
    jstep_fn = jstep.make_train_step(jcfg, model.apply, tx,
                                     donate=False).__wrapped__
    tstate_ = tstate.init_state(tcfg, 0, "cpu")
    tstate_.net.load_state_dict(weights.from_flax(
        jax.tree.map(np.asarray, state.params)))
    tstep_fn = tstep.make_train_step(tcfg, tstate_.net, sweep=sweep)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    lr = tcfg.learning_rate
    noise = {name: torch.zeros_like(p, dtype=torch.bool)
             for name, p in tstate_.net.named_parameters()}
    for k in (1, 2):
        state, jm = jstep_fn(state, jbatch, jax.random.PRNGKey(1))
        tstate_, tm = tstep_fn(tstate_, tbatch)
        assert tstate_.step == int(state.step) == k
        assert set(tm) == {"total_loss", "reconstruction_loss", "grad_norm"}
        for key in tm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
        want = weights.from_flax(jax.tree.map(np.asarray, state.params))
        for name, p in tstate_.net.named_parameters():
            g = p.grad.abs()
            noise[name] |= g < 1e-6 * g.max()
            tol = torch.where(noise[name], 2 * lr * k, 1e-2 * lr * k)
            err = (p.detach() - want[name]).abs()
            assert bool((err <= tol).all()), (name, k, float(err.max()))


def test_losses_match_jax():
    """l2_loss exactly in form (0.5 * sum of squares, weights on both
    images); spherical_weights to rtol 1e-4 (the port forms it in float64,
    JAX in float32, whose cosine difference cancels near the equator)."""
    rng = np.random.RandomState(2)
    p, t = rng.rand(2, 8, 16, 3).astype(np.float32), \
        rng.rand(2, 8, 16, 3).astype(np.float32)
    wgt = np.asarray(jbasic.spherical_weights(8, 16))
    np.testing.assert_allclose(tbasic.spherical_weights(8, 16).numpy(), wgt,
                               rtol=1e-4)
    sw = tbasic.spherical_weights(8, 16)[None, :, :, None]
    np.testing.assert_allclose(
        float(tbasic.l2_loss(torch.from_numpy(p), torch.from_numpy(t), sw)),
        float(jbasic.l2_loss(jnp.asarray(p), jnp.asarray(t),
                             jnp.asarray(wgt)[None, :, :, None])),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tbasic.l2_loss(torch.from_numpy(p), torch.from_numpy(t))),
        0.5 * float(np.sum((p - t) ** 2)), rtol=1e-6)


@pytest.mark.parametrize("kw, exc, match", [
    (dict(gcn=True, transform_inverse_reg=True), ValueError,
     r"gcn with transform_inverse_reg.*step\.py:84-87"),
    (dict(supervision="tgt_hrestgt", spherical_attention=True), ValueError,
     r"step\.py:58-59.*does not broadcast"),
    (dict(supervision="tgt_hrestgt", input_type="PP"), ValueError,
     "high-res target is an ODS render"),
    (dict(num_data_shards=2), ValueError,
     "batch_size 1 must divide evenly across num_data_shards 2")])
def test_unported_training_options_raise(kw, exc, match):
    """validate() and the loss refuse the combinations the JAX trainer
    cannot run either, naming why (the GCN with the transform-inverse
    regularizer; spherical attention's low-res latitude map on the
    high-res render; a high-res target of perspective input; a batch that
    does not split evenly across the data shards)."""
    with pytest.raises(exc, match=match):
        MatryConfig(**TINY, **kw).validate()
    net = tstate.build_model(MatryConfig(**TINY))
    with pytest.raises(exc, match=match):
        tstep.make_loss_fn(MatryConfig(**TINY, **kw), net)


def test_to_flax_inverts_from_flax():
    """Bit-exact round trip of every leaf, both variants."""
    for coord in (False, True):
        jcfg = JaxConfig(**TINY, coord_net=coord).validate()
        state, _ = jstate.init_state(jcfg, jax.random.PRNGKey(3))
        tree = jax.tree.map(np.asarray, state.params)
        back = weights.to_flax(weights.from_flax(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
