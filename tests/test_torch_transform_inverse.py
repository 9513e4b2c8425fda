"""The port's transform-inverse regularizer against the JAX package's, on
CPU, float32 (ROADMAP Queue 1 item 6.1).

* `rotation_from_euler` against JAX's at rtol 1e-6; `random_jitter_pose`
  draws from the generator in its stated ranges, reproducibly.
* The jittered gather sweep (`format_network_input(jitter_pose_inv=...)`)
  against JAX's: every shell but the farthest (100 m) to a mean of 1e-4
  with no value off by 2e-3; on the farthest, < 10% of values park in one
  package and not the other (the tangency discriminant's sign is float32
  cancellation noise there, ROADMAP Queue 3; 3.7% and 4.0% of the two
  eyes' at the replayed pose) and the rest to a mean of 1e-3 (its
  lookups carry float32 noise of up to 4e-5 px per metre, 4e-3 px at
  100 m: grids.NOISE_PX_PER_M; 2.7e-4 measured).
* `sweep_stage` with a jitter pose never reaches the identity-pose sweep
  (`ops/sweep.sweep_volume`, the K1 wrapper).
* The train step's total, reconstruction and enforcement losses and every
  parameter gradient with `transform_inverse_reg` against
  `jax.value_and_grad(make_loss_fn(...))`, wrap and coord net, pixel loss
  and E-LPIPS, at test_torch_train.py's tolerances (losses rtol 1e-5,
  gradients 1e-4 of a leaf's largest). JAX's jitter pose (drawn from
  `jax.random.split(rng, 6)[0]`) is replayed through the loss's
  `jitter_pose`; both forwards take the JAX gather sweep's volume on both
  sides (test_torch_train.py; for the jittered one, because of the far
  shell's park flips above, through the loss's `sweep_jitter`). E-LPIPS
  replays JAX's recorded draws, the reconstruction term's then the
  enforcement term's.
* One Adam step against JAX's train step, at test_torch_train.py's
  parameter tolerance.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import cameras as jcameras
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.losses.elpips import api as japi
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.geometry import cameras as tcameras
from matryodshka_tpu_torch.geometry import sweep as tsweep
from matryodshka_tpu_torch.losses.elpips import api as tapi
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from matryodshka_tpu_torch.training import state as tstate
from matryodshka_tpu_torch.training import step as tstep
from test_torch_elpips import JaxDraws, jax_metric, port_draws, \
    write_jax_weights
from test_torch_train import TINY, _assert_grads_close, _setup, _torch_net

torch.set_num_threads(1)
RNG = jax.random.PRNGKey(1)
#: (coord_net, which_loss, rot_factor, tr_factor) of each case.
CASES = {"wrap_pixel": (False, "pixel", 1.0, 1.0),
         "coord_pixel": (True, "pixel", 1.0, 1.0),
         "wrap_pixel_factors": (False, "pixel", 2.0, 3.0),
         "wrap_elpips": (False, "elpips", 1.0, 1.0),
         "coord_elpips": (True, "elpips", 1.0, 1.0)}
SCALE_SWAP = (2, True)


def jax_jitter_pose(jcfg, rng):
    """The pose JAX's loss draws from rng (step.py:98-101)."""
    return np.asarray(jcameras.random_jitter_pose(
        jax.random.split(rng, 6)[0], jcfg.rot_factor, jcfg.tr_factor))


def test_rotation_from_euler_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        a = rng.uniform(-3.2, 3.2, 3).astype(np.float32)
        want = np.asarray(jcameras.rotation_from_euler(jnp.asarray(a)))
        got = tcameras.rotation_from_euler(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_random_jitter_pose_ranges_and_replay():
    """Angles within +-0.03 rot_factor rad (read back through the
    rotation), offsets within +-0.01 tr_factor, a rigid pose, and the same
    pose from a generator seeded alike."""
    g = torch.Generator().manual_seed(3)
    poses = [tcameras.random_jitter_pose(g, 2.0, 3.0) for _ in range(20)]
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(poses[0], tcameras.random_jitter_pose(g2, 2.0, 3.0))
    for p in poses:
        assert p.dtype == torch.float32 and p.shape == (4, 4)
        assert torch.equal(p[3], torch.tensor([0.0, 0, 0, 1]))
        assert float(p[:3, 3].abs().max()) <= 0.03
        r = p[:3, :3].double()
        assert torch.allclose(r @ r.T, torch.eye(3, dtype=torch.float64),
                              atol=1e-6)
        # R = Rz Ry Rx: ay = -asin(R[2, 0])
        assert abs(float(torch.asin(-r[2, 0]))) <= 0.06 + 1e-6
    assert len({tuple(p.flatten().tolist()) for p in poses}) == 20


def jax_jittered_volume(batch, pose):
    """JAX's jittered gather sweep [B, H, W, 2*P*3] at pose (JAX
    inverts it as the loss does)."""
    inv = jnp.linalg.inv(jnp.asarray(pose))[None]
    depths = jnp.asarray(jsweep.inv_depths(1.0, 100.0, 4))
    return np.asarray(jsweep.format_network_input(
        jmsi.preprocess_image(batch["ref_image"]),
        jmsi.preprocess_image(batch["src_image"]), batch["ref_pose"],
        batch["src_pose"], batch["ref_pose_inv"], depths,
        batch["intrinsics"], jitter_pose_inv=inv)), np.asarray(inv)


def test_jittered_format_network_input_matches_jax():
    jcfg, tcfg, _, batch, _ = _setup(transform_inverse_reg=True)
    want, inv = jax_jittered_volume(batch, jax_jitter_pose(jcfg, RNG))
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, 4), np.float32)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tsweep.format_network_input(
        tmsi.preprocess_image(t["ref_image"]),
        tmsi.preprocess_image(t["src_image"]), t["ref_pose"], t["src_pose"],
        t["ref_pose_inv"], torch.from_numpy(depths), t["intrinsics"],
        jitter_pose_inv=torch.from_numpy(inv)).numpy()
    err = np.abs(got - want).reshape(32, 64, 2, 4, 3)
    far, near = err[:, :, :, 0], err[:, :, :, 1:]
    assert near.max() < 2e-3 and near.mean() < 1e-4, (near.max(),
                                                      near.mean())
    flip = far > 2e-3
    assert flip.mean() < 0.1, flip.mean()
    assert far[~flip].mean() < 1e-3, far[~flip].mean()
    unjittered = tsweep.format_network_input(
        tmsi.preprocess_image(t["ref_image"]),
        tmsi.preprocess_image(t["src_image"]), t["ref_pose"], t["src_pose"],
        t["ref_pose_inv"], torch.from_numpy(depths), t["intrinsics"]).numpy()
    assert np.abs(unjittered - got).max() > 1e-2


def test_jittered_sweep_stage_takes_the_gather_route(monkeypatch):
    """With a jitter pose, sweep_stage never calls the identity-pose sweep
    (the K1 wrapper, which reads no pose) and counts one gather sweep;
    without one it calls it once and makes no gather sweep."""
    calls = []
    real = sweep_ops.sweep_volume

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(sweep_ops, "sweep_volume", spy)
    _, tcfg, _, batch, _ = _setup(transform_inverse_reg=True)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    d = torch.tensor(tsweep.inv_depths(1.0, 100.0, 4))
    pose = tcameras.random_jitter_pose(torch.Generator().manual_seed(0))
    before = tsweep.gather_sweeps
    vol = tmsi.sweep_stage(tcfg, t, d, torch.linalg.inv(pose)[None])
    assert calls == [] and tsweep.gather_sweeps == before + 1
    assert vol.shape == (1, 24, 32, 64) and vol.dtype == torch.float32
    bcfg = MatryConfig(**dict(TINY, compute_dtype="bfloat16"))
    assert tmsi.sweep_stage(bcfg, t, d, torch.linalg.inv(pose)[None]
                            ).dtype == torch.bfloat16
    tmsi.sweep_stage(tcfg, t, d)
    assert calls == [1] and tsweep.gather_sweeps == before + 2


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


@pytest.mark.parametrize("name", list(CASES))
def test_reg_loss_and_grads_match_jax(request, name):
    coord, loss, rot, tr = CASES[name]
    kw = dict(transform_inverse_reg=True, coord_net=coord, which_loss=loss,
              rot_factor=rot, tr_factor=tr)
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    captured, elpips = [], None
    if loss == "elpips":
        metric, path = request.getfixturevalue("elpips_pair")

        def elpips_fn(p, t, rng):
            d, draws = metric(p, t, rng)
            captured.append(draws)
            return d
    else:
        elpips_fn = None
    loss_fn = jstep.make_loss_fn(jcfg, model.apply, elpips_fn)

    def loss_with_draws(params, b, rng):
        captured.clear()
        total, aux = loss_fn(params, b, rng)
        return total, (aux, list(captured))

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jaux, draws)), jgrads = jax.value_and_grad(
        loss_with_draws, has_aux=True)(state.params, jbatch, RNG)
    if loss == "elpips":
        assert len(draws) == 2
        tm = tapi.Metric(tapi.elpips_vgg(batch_size=1), weight_path=path)
        replay = iter([port_draws(d, swap=SCALE_SWAP[1]) for d in draws])
        elpips = lambda p, t, g: tm(p, t, draws=next(replay))  # noqa: E731
    net = _torch_net(tcfg, state.params)
    tloss = tstep.make_loss_fn(tcfg, net, sweep=sweep, elpips=elpips)
    pose = jax_jitter_pose(jcfg, RNG)
    vol_j = torch.from_numpy(jax_jittered_volume(batch, pose)[0])
    tloss.sweep_jitter = lambda b, p: vol_j.permute(0, 3, 1, 2)
    pose = torch.from_numpy(pose)
    total, aux = tloss({k: torch.from_numpy(v) for k, v in batch.items()},
                       jitter_pose=pose)
    total.backward()
    assert aux["rgba_layers_jitter"].shape == aux["rgba_layers"].shape
    assert aux["jitter_output_image"].shape == (1, 32, 64, 3)
    for k in ("total_loss", "reconstruction_loss", "enforcement_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(aux["enforcement_loss"]) > 0
    _assert_grads_close(net, jgrads["params"], 1e-4)


def test_reg_adam_step_matches_jax():
    """One step of each package's train step from the same parameters:
    metrics to rtol 1e-4, parameters to test_torch_train.py's bound. The
    port's step replays the pose JAX draws from fold_in(rng, step)."""
    jcfg, tcfg, state, batch, sweep = _setup(transform_inverse_reg=True)
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    jstep_fn = jstep.make_train_step(jcfg, model.apply,
                                     jstate.build_optimizer(jcfg),
                                     donate=False).__wrapped__
    pose = jax_jitter_pose(jcfg, jax.random.fold_in(RNG, 0))
    vol_j = torch.from_numpy(jax_jittered_volume(batch, pose)[0])
    pose = torch.from_numpy(pose)
    ts = tstate.init_state(tcfg, 0, "cpu")
    ts.net.load_state_dict(weights.from_flax(
        jax.tree.map(np.asarray, state.params)))
    loss_fn = tstep.make_loss_fn(tcfg, ts.net, sweep=sweep)
    loss_fn.sweep_jitter = lambda b, p: vol_j.permute(0, 3, 1, 2)
    state, jm = jstep_fn(state, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, RNG)
    ts.optimizer.zero_grad(set_to_none=True)
    total, aux = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                         jitter_pose=pose)
    total.backward()
    tm = tstep.scalar_metrics(aux)
    tm["grad_norm"] = tstep.grad_norm(list(ts.net.parameters()))
    ts.optimizer.step()
    assert set(tm) == {"total_loss", "reconstruction_loss",
                       "enforcement_loss", "grad_norm"}
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    lr = tcfg.learning_rate
    want = weights.from_flax(jax.tree.map(np.asarray, state.params))
    for name, p in ts.net.named_parameters():
        g = p.grad.abs()
        tol = torch.where(g < 1e-6 * g.max(), 2 * lr, 1e-2 * lr)
        err = (p.detach() - want[name]).abs()
        assert bool((err <= tol).all()), (name, float(err.max()))


def test_train_step_draws_the_pose_from_the_generator():
    """make_train_step draws the pose from state.generator before
    E-LPIPS: two states seeded alike give equal losses; a differently
    seeded one another enforcement loss; and a pose drawn from a
    generator seeded alike replays the step's loss."""
    _, tcfg, state, batch, sweep = _setup(transform_inverse_reg=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for seed in (5, 5, 6):
        ts = tstate.init_state(tcfg, 0, "cpu")
        ts.net.load_state_dict(weights.from_flax(
            jax.tree.map(np.asarray, state.params)))
        ts.generator.manual_seed(seed)
        _, m = tstep.make_train_step(tcfg, ts.net, sweep=sweep)(ts, tbatch)
        out.append(float(m["enforcement_loss"]))
    assert out[0] == out[1] != out[2]
    ts = tstate.init_state(tcfg, 0, "cpu")
    ts.net.load_state_dict(weights.from_flax(
        jax.tree.map(np.asarray, state.params)))
    loss_fn = tstep.make_loss_fn(tcfg, ts.net, sweep=sweep)
    pose = loss_fn.draw_jitter(torch.Generator().manual_seed(5))
    with torch.no_grad():
        _, aux = loss_fn(tbatch, jitter_pose=pose)
    assert float(aux["enforcement_loss"]) == out[0]


@pytest.mark.parametrize("kw", [dict(transform_inverse_reg=True),
                                dict(rot_factor=0.5, tr_factor=2.0)])
def test_reg_config_validates(kw):
    """transform_inverse_reg, rot_factor and tr_factor validate (they
    raised before the regularizer was ported)."""
    cfg = MatryConfig(**TINY, **kw).validate()
    net = tstate.build_model(cfg)
    assert tstep.make_loss_fn(cfg, net).cfg is cfg


def test_loop_trains_with_the_regularizer(tmp_path):
    """Two steps of training/loop.train with the regularizer on the CPU:
    finite losses, and every record carries the enforcement loss."""
    import json

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.training import loop as loop_lib
    cfg = MatryConfig(**TINY, transform_inverse_reg=True, max_steps=2,
                      summary_freq=1, checkpoint_dir=str(tmp_path),
                      experiment_name="r").validate()
    st = tstate.init_state(cfg, 0, "cpu")
    loop_lib.train(cfg, st, tstep.make_train_step(cfg, st.net),
                   itertools.repeat(entry.synthetic_batch(cfg, 0, "cpu")))
    recs = [json.loads(line) for line in
            (tmp_path / "r" / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
    assert len(recs) == 2
    assert all(np.isfinite(r["enforcement_loss"]) and r["enforcement_loss"]
               > 0 for r in recs)
