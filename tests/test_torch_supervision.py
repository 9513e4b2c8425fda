"""The port's src/ref supervision against the JAX package's, on CPU, float32
(ROADMAP Queue 1 item 6.2).

* The train step's total and aux losses and every parameter gradient for
  supervision tgt_src, tgt_ref, tgt_src_ref and src_ref, with and without
  transform_inverse_reg, with the pixel loss and with E-LPIPS, against
  `jax.value_and_grad(make_loss_fn(...))` at test_torch_train.py's
  tolerances (losses rtol 1e-5, gradients 1e-4 of a leaf's largest). Both
  sides take the JAX gather sweep's volumes (test_torch_train.py,
  test_torch_transform_inverse.py), and the port replays JAX's jitter
  pose. E-LPIPS replays JAX's recorded draws in its call order (tgt, src,
  ref, enforcement, then the jittered src and ref terms, whose JAX keys
  are the unjittered terms').
* With the port's own Metric, the jittered eye terms render the
  unjittered layers and take the very draws of their unjittered twins,
  and the step draws one set per distinct key in the JAX key order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.losses.elpips import api as japi
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch.losses.elpips import api as tapi
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.training import step as tstep
from test_torch_elpips import JaxDraws, jax_metric, port_draws, \
    write_jax_weights
from test_torch_train import _assert_grads_close, _setup, _torch_net
from test_torch_transform_inverse import jax_jitter_pose, \
    jax_jittered_volume

torch.set_num_threads(1)
RNG = jax.random.PRNGKey(1)
SUPERVISIONS = ("tgt_src", "tgt_ref", "tgt_src_ref", "src_ref")
SCALE_SWAP = (2, True)


@pytest.fixture(scope="module")
def elpips_pair(tmp_path_factory):
    """The JAX trainer's metric jitted at SCALE_SWAP, returning its
    distances and its recorded draw, and a JAX-layout .npz of its weights
    (test_torch_train_elpips.py)."""
    jm = jax_metric(japi.elpips_vgg(batch_size=1))
    path = write_jax_weights(jm, tmp_path_factory.mktemp("w") / "w.npz")
    with pytest.MonkeyPatch.context() as mp:
        rec = JaxDraws(mp)

        def metric(p, t, rng):
            rec.clear()
            return jm.forward(p, t, rng, static_scale_swap=SCALE_SWAP), \
                rec.draws

        yield jax.jit(metric), path


def _jax_loss(jcfg, state, batch, elpips_fn):
    """JAX's loss, aux, gradients and the draws its E-LPIPS calls made,
    in call order."""
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    captured = []
    fn = None
    if elpips_fn is not None:
        def fn(p, t, rng):
            d, draws = elpips_fn(p, t, rng)
            captured.append(draws)
            return d
    loss_fn = jstep.make_loss_fn(jcfg, model.apply, fn)

    def loss_with_draws(params, b, rng):
        captured.clear()
        total, aux = loss_fn(params, b, rng)
        return total, (aux, list(captured))

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jaux, draws)), jgrads = jax.value_and_grad(
        loss_with_draws, has_aux=True)(state.params, jbatch, RNG)
    return jloss, jaux, jgrads, draws


def _port_loss(jcfg, tcfg, state, batch, sweep, elpips=None):
    """The port's loss on JAX's volumes (and JAX's pose with the
    regularizer); returns (net, total, aux) after the backward."""
    net = _torch_net(tcfg, state.params)
    tloss = tstep.make_loss_fn(tcfg, net, sweep=sweep, elpips=elpips)
    pose = None
    if tcfg.transform_inverse_reg:
        pose = jax_jitter_pose(jcfg, RNG)
        vol_j = torch.from_numpy(jax_jittered_volume(batch, pose)[0])
        tloss.sweep_jitter = lambda b, p: vol_j.permute(0, 3, 1, 2)
        pose = torch.from_numpy(pose)
    total, aux = tloss({k: torch.from_numpy(v) for k, v in batch.items()},
                       jitter_pose=pose)
    total.backward()
    return net, total, aux


def _check(jloss, jaux, jgrads, net, total, aux):
    keys = ("total_loss", "reconstruction_loss", "enforcement_loss")
    for k in keys:
        assert (k in aux) == (k in jaux), k
        if k in aux:
            np.testing.assert_allclose(aux[k].detach().item(), float(jaux[k]),
                                       rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.detach().item(), float(jloss), rtol=1e-5)
    _assert_grads_close(net, jgrads["params"], 1e-4)


@pytest.mark.parametrize("reg", [False, True])
@pytest.mark.parametrize("supervision", SUPERVISIONS)
def test_eye_terms_pixel_match_jax(supervision, reg):
    """The pixel loss: each eye term weighs 1e-4 without the regularizer,
    1 with it, where the eyes are rendered again at the jitter pose."""
    kw = dict(supervision=supervision, transform_inverse_reg=reg)
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    jloss, jaux, jgrads, _ = _jax_loss(jcfg, state, batch, None)
    net, total, aux = _port_loss(jcfg, tcfg, state, batch, sweep)
    _check(jloss, jaux, jgrads, net, total, aux)
    assert ("output_image" in aux) == ("tgt" in supervision)


@pytest.mark.parametrize("reg", [False, True])
@pytest.mark.parametrize("supervision", SUPERVISIONS)
def test_eye_terms_elpips_match_jax(elpips_pair, supervision, reg):
    """E-LPIPS at JAX's recorded draws, replayed in its call order: one a
    term (tgt, src, ref, enforcement), and with the regularizer the
    jittered eye terms again, whose recorded draws are their unjittered
    twins' (the same key)."""
    metric, path = elpips_pair
    kw = dict(supervision=supervision, transform_inverse_reg=reg,
              which_loss="elpips")
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    jloss, jaux, jgrads, draws = _jax_loss(jcfg, state, batch, metric)
    eyes = [k for k in ("src", "ref") if k in supervision]
    unjittered = int("tgt" in supervision) + len(eyes)
    want = unjittered + (int("tgt" in supervision) + len(eyes)) * reg
    assert len(draws) == want
    if reg:
        # the jittered eye terms draw at their unjittered twins' keys
        first = int("tgt" in supervision)
        for i in range(len(eyes)):
            a = draws[first + i]
            b = draws[unjittered + int("tgt" in supervision) + i]
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=1), weight_path=path)
    replay = iter([port_draws(d, swap=SCALE_SWAP[1]) for d in draws])
    net, total, aux = _port_loss(
        jcfg, tcfg, state, batch, sweep,
        elpips=lambda p, t, g: tm(p, t, draws=next(replay)))
    assert next(replay, None) is None
    _check(jloss, jaux, jgrads, net, total, aux)


def test_jittered_eye_terms_reuse_layers_and_draws(monkeypatch):
    """With the port's Metric: the step draws one set per term in the
    JAX key order (tgt, src, ref, enforcement) from the generator, after
    the pose; the jittered src and ref terms render the UNJITTERED layers
    (JAX step.py:154-162) at the jitter pose and take the very Draw
    lists of their unjittered twins."""
    jcfg, tcfg, state, batch, sweep = _setup(
        supervision="tgt_src_ref", transform_inverse_reg=True,
        which_loss="elpips")
    net = _torch_net(tcfg, state.params)
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=1))
    calls, renders = [], []
    real_forward = tm.forward

    def spy_forward(p, t, generator=None, draws=None):
        calls.append(draws)
        return real_forward(p, t, generator, draws)

    real_ods = tmsi.render_ods_view

    def spy_ods(rgba, order, pose, *a):
        renders.append((rgba, order, pose))
        return real_ods(rgba, order, pose, *a)

    monkeypatch.setattr(tm, "forward", spy_forward)
    monkeypatch.setattr(tmsi, "render_ods_view", spy_ods)
    tloss = tstep.make_loss_fn(tcfg, net, sweep=sweep, elpips=tm)
    assert tloss.terms == ["tgt", "src", "ref", "enforcement"]
    vol_j = torch.from_numpy(jax_jittered_volume(
        batch, jax_jitter_pose(jcfg, RNG))[0])
    tloss.sweep_jitter = lambda b, p: vol_j.permute(0, 3, 1, 2)
    g = torch.Generator().manual_seed(7)
    _, aux = tloss({k: torch.from_numpy(v) for k, v in batch.items()}, g)

    # calls: tgt, src, ref, enforcement, jittered src, jittered ref
    assert len(calls) == 6 and all(len(d) == 1 for d in calls)
    assert calls[4] is calls[1] and calls[5] is calls[2]
    assert len({id(d) for d in calls[:4]}) == 4
    # the order of the draws: the pose, then one per term in key order
    g2 = torch.Generator().manual_seed(7)
    pose = tloss.draw_jitter(g2)
    for i in range(4):
        want, got = tm.draw(1, g2), calls[i][0]
        assert want.seed == got.seed
        for a, b in zip(want.params, got.params):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert len(renders) == 4
    rgba = aux["rgba_layers"]
    assert all(r[0] is rgba for r in renders)
    assert [r[1] for r in renders] == [-1, 1, -1, 1]
    eye = torch.eye(4)
    assert torch.equal(renders[0][2][0], eye)
    assert torch.equal(renders[2][2][0], pose.to(renders[2][2].device))
