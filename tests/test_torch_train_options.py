"""The port's remaining trainer options against the JAX package's, on CPU
(ROADMAP Queue 1 items 6.3-6.6): the high-res target, remat_network,
param_dtype, use_pallas and the train CLI's --dry_run,
--dry_run_inference and --profile_steps.

* `assemble_hres_rgba` for each colour scheme against JAX's (the JAX
  layout from the port's planar volume), to 1e-6.
* The tgt_hrestgt loss and every gradient against `jax.value_and_grad`
  of JAX's loss (infer_msi(with_hres=True)), 32x64 and 64x128 high res,
  at test_torch_train.py's tolerances; both sides take JAX's gather
  volumes at both sizes (the port's through its `sweep` argument, which
  it also calls for the high-res pair).
* remat_network: the port's gradients bit-equal to its step without it
  (with the regularizer too: both forwards recomputed), the net's
  forward run twice a forward; and against JAX's remat step.
* param_dtype=bfloat16: the parameters and Adam's moments in bfloat16,
  and one Adam step against JAX's (bound in the test).
* use_pallas=false: the trainer and the test CLI call no kernel wrapper
  and sweep by gather; the trainer's loss and gradients and the test
  CLI's outputs (high res too) against the JAX package's.
* The train CLI: --dry_run and --dry_run_inference write the JAX
  run_dry_run's files, each PNG within one level (1/255) of JAX's;
  --profile_steps writes a trace; the new options train.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.cli import test as jcli
from matryodshka_tpu.cli import train as jtrain
from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.data import loader as jloader
from matryodshka_tpu.data import native as jnative
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch import entry, weights
from matryodshka_tpu_torch.data import native as tnative
from matryodshka_tpu_torch.cli import test as tcli
from matryodshka_tpu_torch.cli import train as cli_train
from matryodshka_tpu_torch.config import COLOR_PREDS, MatryConfig
from matryodshka_tpu_torch.data.loader import make_loader
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as tsweep
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import render_layers as rl_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from matryodshka_tpu_torch.ops import wrap_conv as wc
from matryodshka_tpu_torch.training import state as tstate
from matryodshka_tpu_torch.training import step as tstep
from matryodshka_tpu_torch.training.checkpoint import CheckpointManager
from test_torch_train import TINY, _assert_grads_close, _numpy_batch, \
    _setup, _torch_net

torch.set_num_threads(1)
RNG = jax.random.PRNGKey(1)
HRES = dict(hres_height=64, hres_width=128)
#: test_torch_cli.py's depths: at 100 m the gather and the identity-pose
#: sweep park different pixels (ROADMAP Queue 3).
DEPTHS = dict(min_depth=2.0, max_depth=20.0)


def _jax_volume(batch, prefix=""):
    """JAX's gather sweep of the batch's (prefix-named) pair, as the port's
    planar [B, 2*P*3, H, W] tensor."""
    depths = jnp.asarray(jsweep.inv_depths(1.0, 100.0, 4))
    psv = np.asarray(jsweep.format_network_input(
        jmsi.preprocess_image(batch[prefix + "ref_image"]),
        jmsi.preprocess_image(batch[prefix + "src_image"]), batch["ref_pose"],
        batch["src_pose"], batch["ref_pose_inv"], depths,
        batch["intrinsics"]))
    return torch.from_numpy(psv.copy()).permute(0, 3, 1, 2).contiguous()


def _jax_loss_and_grads(jcfg, state, batch):
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    loss_fn = jstep.make_loss_fn(jcfg, model.apply)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(loss_fn, has_aux=True)(state.params, jbatch,
                                                     RNG)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The high-res target.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", COLOR_PREDS)
def test_assemble_hres_rgba_matches_jax(scheme):
    """The upsampled-weight assembly of every scheme, from the same
    assemble_rgba outputs and high-res volume (alpha_only and
    blend_bg_psv take the foreground as it is, as JAX's does)."""
    rng = np.random.RandomState(3)
    p, (h, w), (hh, hw) = 4, (8, 16), (16, 32)
    k = MatryConfig(which_color_pred=scheme, num_msi_planes=p,
                    num_psv_planes=p).num_net_outputs()
    pred = rng.uniform(-1, 1, (1, h, w, k)).astype(np.float32)
    low = rng.uniform(-1, 1, (1, h, w, 6 * p)).astype(np.float32)
    vol = rng.uniform(-1, 1, (1, hh, hw, 6 * p)).astype(np.float32)
    jout = jmsi.assemble_rgba(scheme, jnp.asarray(pred), jnp.asarray(low), p)
    want = np.asarray(jmsi.assemble_hres_rgba(scheme, jout, jnp.asarray(vol),
                                              p, hh, hw))
    tout = tmsi.assemble_rgba(scheme, torch.from_numpy(pred),
                              torch.from_numpy(low), p)
    got = tmsi.assemble_hres_rgba(
        scheme, tout, torch.from_numpy(vol).permute(0, 3, 1, 2), p)
    assert got.shape == want.shape == (1, hh, hw, p, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _hres_batch(batch, seed=1):
    rng = np.random.RandomState(seed)
    out = dict(batch)
    for k in ("ref", "src", "tgt"):
        out[f"hres_{k}_image"] = rng.rand(
            1, HRES["hres_height"], HRES["hres_width"], 3).astype(np.float32)
    return out


def test_hrestgt_loss_and_grads_match_jax():
    """tgt_hrestgt: the loss (0.5 * the sums of squares over the low-res
    and the high-res render) to rtol 1e-5, every gradient to 1e-4 of its
    largest; the port sweeps twice, the second time the high-res pair."""
    jcfg, tcfg, state, batch, _ = _setup(supervision="tgt_hrestgt", **HRES)
    batch = _hres_batch(batch)
    (jloss, jaux), jgrads = _jax_loss_and_grads(jcfg, state, batch)
    vols = {32: _jax_volume(batch), 64: _jax_volume(batch, "hres_")}
    seen = []

    def sweep(cfg, b, d):
        seen.append(b["ref_image"].shape[1])
        return vols[b["ref_image"].shape[1]]

    net = _torch_net(tcfg, state.params)
    loss, aux = tstep.make_loss_fn(tcfg, net, sweep=sweep)(_tbatch(batch))
    loss.backward()
    assert seen == [32, 64]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["reconstruction_loss"].item(),
                               float(jaux["reconstruction_loss"]), rtol=1e-5)
    assert loss.item() > 1.5 * aux["reconstruction_loss"].item()
    _assert_grads_close(net, jgrads["params"], 1e-4)


def test_hrestgt_elpips_draws_in_key_order(monkeypatch):
    """With E-LPIPS and the port's Metric, tgt_hrestgt draws the target
    term's set, then the high-res term's (JAX's rng_l1, rng_l2), from the
    generator, and the high-res term sees the 64x128 render."""
    from matryodshka_tpu_torch.losses.elpips import api as tapi
    _, tcfg, state, batch, _ = _setup(supervision="tgt_hrestgt",
                                      which_loss="elpips", **HRES)
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=1))
    calls = []
    real = tm.forward

    def spy(p, t, generator=None, draws=None):
        calls.append((tuple(p.shape), draws))
        return real(p, t, generator, draws)

    monkeypatch.setattr(tm, "forward", spy)
    loss_fn = tstep.make_loss_fn(tcfg, _torch_net(tcfg, state.params),
                                 elpips=tm)
    assert loss_fn.terms == ["tgt", "hrestgt"]
    loss, _ = loss_fn(_tbatch(_hres_batch(batch)),
                      torch.Generator().manual_seed(3))
    assert np.isfinite(loss.item())
    assert [c[0] for c in calls] == [(1, 32, 64, 3), (1, 64, 128, 3)]
    g = torch.Generator().manual_seed(3)
    for _, draws in calls:
        want = tm.draw(1, g)
        assert draws[0].seed == want.seed
        assert draws[0].params.scale_level == want.params.scale_level


def test_hrestgt_sweeps_the_high_res_pair_and_loads_it(tmp_path):
    """The step's sweep_stage runs twice (the identity-pose sweep's
    wrapper, K1 on the card), the second time on the 64x128 pair with the
    low-res intrinsics; make_loader reads the high-res images."""
    from matryodshka_tpu_torch.data import synthetic
    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=32, width=64)
    cfg = MatryConfig(**TINY, **HRES, supervision="tgt_hrestgt",
                      image_dir=str(tmp_path / "fix" / "images"),
                      hres_image_dir=str(tmp_path / "fix" / "images"),
                      cameras_glob=glob_pat).validate()
    loader = make_loader(cfg, training=True)
    assert loader.load_hres
    batch = next(loader.batches())
    assert batch["hres_tgt_image"].shape == (1, 64, 128, 3)
    calls = []
    real = sweep_ops.sweep_volume

    def spy(ref, src, depths, intr, **kw):
        calls.append((tuple(ref.shape), intr))
        return real(ref, src, depths, intr, **kw)

    st = tstate.init_state(cfg, 0, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sweep_ops, "sweep_volume", spy)
        _, m = tstep.make_train_step(cfg, st.net)(st, _tbatch(
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}))
    assert [c[0] for c in calls] == [(1, 32, 64, 3), (1, 64, 128, 3)]
    assert torch.equal(calls[0][1], calls[1][1])
    assert np.isfinite(float(m["total_loss"]))


# ---------------------------------------------------------------------------
# remat_network.
# ---------------------------------------------------------------------------

def _grads(tcfg, params, batch, sweep, pose=None, vol_j=None):
    net = _torch_net(tcfg, params)
    calls = []
    forward = net.forward

    def counted(*a, **k):
        calls.append(1)
        return forward(*a, **k)

    net.forward = counted
    loss_fn = tstep.make_loss_fn(tcfg, net, sweep=sweep)
    if vol_j is not None:
        loss_fn.sweep_jitter = lambda b, p: vol_j
    loss, _ = loss_fn(_tbatch(batch), jitter_pose=pose)
    n_fwd = len(calls)
    loss.backward()
    return loss, {n: p.grad for n, p in net.named_parameters()}, n_fwd, \
        len(calls) - n_fwd


@pytest.mark.parametrize("reg", [False, True])
def test_remat_grads_equal_the_plain_step(reg):
    """Bit-equal loss and gradients with and without remat_network (the
    recomputed forward is the same computation on the CPU); with it each
    forward of the net runs again in the backward (twice under the
    regularizer, both forwards), without it never."""
    kw = dict(transform_inverse_reg=reg)
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    pose = vol_j = None
    if reg:
        pose = torch.tensor([[1.0, 0, 0, 0.01], [0, 1.0, 0, 0],
                             [0, 0, 1.0, -0.005], [0, 0, 0, 1]])
        vol_j = tmsi.sweep_stage(tcfg, _tbatch(batch), torch.tensor(
            tsweep.inv_depths(1.0, 100.0, 4)), torch.linalg.inv(pose)[None])
    loss0, g0, f0, b0 = _grads(tcfg, state.params, batch, sweep, pose, vol_j)
    rcfg = MatryConfig(**{**TINY, **kw, "remat_network": True})
    loss1, g1, f1, b1 = _grads(rcfg, state.params, batch, sweep, pose, vol_j)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert (f0, b0) == (f1, 0) == (1 + reg, 0) and b1 == 1 + reg


def test_remat_matches_jax_remat_step():
    """remat_network on both sides: loss to rtol 1e-5, gradients to 1e-4
    of a leaf's largest (test_torch_train.py's)."""
    jcfg, tcfg, state, batch, sweep = _setup(remat_network=True)
    (jloss, _), jgrads = _jax_loss_and_grads(jcfg, state, batch)
    net = _torch_net(tcfg, state.params)
    loss, _ = tstep.make_loss_fn(tcfg, net, sweep=sweep)(_tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_grads_close(net, jgrads["params"], 1e-4)


@pytest.mark.parametrize("stats_min_cin", [0, 160])
def test_remat_reruns_the_k7_forward(stats_min_cin):
    """The trainer's K7 route under remat: each wrap_conv3x3 forward runs
    twice a step (once recomputed), and the gradients are bit-equal to
    the step without remat; stats_min_cin=0 sends every stride-1 conv
    through K7c (its backward reads y and the sums' gradients), 160 none
    at ngf 8 (K7b)."""
    _, tcfg, state, batch, sweep = _setup()
    counts, grads = [], []
    for remat in (False, True):
        cfg = MatryConfig(**{**TINY, "remat_network": remat})
        net = _torch_net(cfg, state.params)
        net.stats_min_cin = stats_min_cin
        calls = []
        real = wc.WrapConv3x3Fn.forward

        def spy(ctx, *a, _real=real, _calls=calls):
            _calls.append(1)
            return _real(ctx, *a)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(wc.WrapConv3x3Fn, "forward", staticmethod(spy))
            loss, _ = tstep.make_loss_fn(cfg, net, sweep=sweep)(
                _tbatch(batch))
            loss.backward()
        counts.append(len(calls))
        grads.append({n: p.grad for n, p in net.named_parameters()})
    assert counts[0] == 8 and counts[1] == 16
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])


# ---------------------------------------------------------------------------
# param_dtype.
# ---------------------------------------------------------------------------

def _ulp_bf16(x):
    """The bfloat16 spacing at |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)));
    the smallest normal's below it."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_bf16_params_adam_step_matches_jax():
    """param_dtype=bfloat16: the net's parameters, their gradients and
    Adam's two moments are bfloat16 on both sides. One step from the same
    bfloat16 parameters: the loss to rtol 1e-5 (float32 compute from the
    same weights); each new parameter p within one bfloat16 step at |p|
    plus lr * 2^-5 of JAX's. Each package forms Adam's update in bfloat16
    in its own order (torch: lerp, mul + addcmul, sqrt, the bias
    correction, + eps, one addcdiv into p; optax: the moments, their bias
    corrections, sqrt, + eps, a division, * lr, + p), so the two updates
    (~lr) differ by a few bfloat16 roundings of lr (2^-8 lr each; 2^-6.1
    lr measured), and each rounds p once; a wrong sign or moment moves a
    parameter by O(lr), the biases (which start at 0, where a step is
    ~2^-8 lr) included. Where a gradient is at noise level (below 1e-6 of
    its leaf's largest) the update may take the other sign: two steps of
    ~lr, each rounded to the grid, 2 lr + one step at |p|."""
    kw = dict(param_dtype="bfloat16")
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), state.params)
    tx = jstate.build_optimizer(jcfg)
    jst = jstate.TrainState(step=state.step, params=params,
                            opt_state=tx.init(params))
    jstep_fn = jstep.make_train_step(jcfg, model.apply, tx,
                                     donate=False).__wrapped__
    jst, jm = jstep_fn(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                       RNG)

    ts = tstate.init_state(tcfg, 0, "cpu")
    ts.net.load_state_dict(weights.from_flax(jax.tree.map(np.asarray,
                                                          params)))
    assert all(p.dtype == torch.bfloat16 for p in ts.net.parameters())
    ts, tm = tstep.make_train_step(tcfg, ts.net, sweep=sweep)(
        ts, _tbatch(batch))
    np.testing.assert_allclose(float(tm["total_loss"]),
                               float(jm["total_loss"]), rtol=1e-5)
    lr = tcfg.learning_rate
    want = weights.from_flax(jax.tree.map(np.asarray, jst.params))
    for name, p in ts.net.named_parameters():
        assert p.dtype == p.grad.dtype == torch.bfloat16, name
        st = ts.optimizer.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == \
            torch.bfloat16, name
        got = p.detach().float().numpy()
        w = want[name].numpy()
        g = p.grad.float().abs().numpy()
        ulp = _ulp_bf16(np.maximum(np.abs(got), np.abs(w)))
        tol = np.where(g < 1e-6 * g.max(), 2 * lr + ulp,
                       ulp + lr * 2.0 ** -5)
        err = np.abs(got - w)
        assert (err <= tol).all(), (name, float((err - tol).max()))
    mu = jst.opt_state[0].mu
    assert all(leaf.dtype == jnp.bfloat16 for leaf in jax.tree.leaves(mu))


def test_bf16_params_checkpoint_round_trip(tmp_path):
    """A bfloat16 net's checkpoint (float32 .npz, the Adam state as is)
    restores bit for bit into a bfloat16 net."""
    cfg = MatryConfig(**TINY, param_dtype="bfloat16",
                      checkpoint_dir=str(tmp_path), experiment_name="b")
    st = tstate.init_state(cfg, 0, "cpu")
    _, tcfg, _, batch, sweep = _setup(param_dtype="bfloat16")
    st, _ = tstep.make_train_step(cfg, st.net, sweep=sweep)(st, _tbatch(batch))
    CheckpointManager(str(tmp_path / "b")).save(st)
    st2 = CheckpointManager(str(tmp_path / "b")).restore(
        tstate.init_state(cfg, 1, "cpu"))
    for (n, a), b in zip(st.net.named_parameters(), st2.net.parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n
    s1 = st.optimizer.state_dict()["state"]
    s2 = st2.optimizer.state_dict()["state"]
    assert all(torch.equal(s1[k]["exp_avg"], s2[k]["exp_avg"]) for k in s1)


# ---------------------------------------------------------------------------
# use_pallas.
# ---------------------------------------------------------------------------

@pytest.fixture
def no_kernel_wrappers(monkeypatch):
    """Fail on any call of a kernel wrapper of the port."""
    def boom(name):
        def f(*a, **k):
            raise AssertionError(f"{name} called")
        return f

    for mod, names in ((sweep_ops, ("sweep_volume",)),
                       (conv_ops, ("conv",)),
                       (render_ops, ("render_blend",)),
                       (rl_ops, ("render_layers", "render_layers_both")),
                       (wc, ("wrap_conv3x3", "conv3x3_wrap",
                             "conv3x3_wrap_dma", "conv3x3_ln_stats"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom(f"{mod.__name__}.{n}"))


def test_use_pallas_false_trainer_matches_jax(no_kernel_wrappers):
    """use_pallas=false: the trainer's net has no K7 route (PyTorch convs)
    and the step sweeps by gather (one format_network_input a step). Its
    loss, each package on its own gather sweep (depths 2-20), to rtol
    1e-5 of JAX's use_pallas=False step; its gradients to 1e-4 of a
    leaf's largest with both packages on JAX's volume (the tiny net's
    first-layer bias gradients move by ~10% of their leaf under the
    ~1e-3 differences of two gathers at a few pixels, test_torch_cli.py's
    TOL; test_torch_train.py feeds JAX's volume for the same reason)."""
    kw = dict(use_pallas=False, **DEPTHS)
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    (jloss, _), jgrads = _jax_loss_and_grads(jcfg, state, batch)
    net = _torch_net(tcfg, state.params)
    assert not net.wrap_conv_kernel
    before = tsweep.gather_sweeps
    with torch.no_grad():
        loss, _ = tstep.make_loss_fn(tcfg, net)(_tbatch(batch))
    assert tsweep.gather_sweeps == before + 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss, _ = tstep.make_loss_fn(tcfg, net, sweep=sweep)(_tbatch(batch))
    loss.backward()
    _assert_grads_close(net, jgrads["params"], 1e-4)


def test_use_pallas_false_test_cli_matches_jax(no_kernel_wrappers):
    """The test CLI with use_pallas=false (the gather sweep, the plain net
    and the gather renders) against the JAX CLI's use_pallas=False
    build_infer_fn, every output within test_torch_cli.py's TOL (2e-3:
    each package gathers its own sweep, and a lookup within float32 noise
    of a pixel edge takes the other pair of taps at a few pixels; 1.9e-3
    measured on the volume, 1.4e-4 on the views); the high-res re-render
    (the shell-streamed gather) against JAX's shell scan at 64x128, the
    same bound."""
    base = dict(TINY, which_color_pred="blend_psv", use_pallas=False,
                **DEPTHS, **HRES)
    jcfg = JaxConfig(**base).validate()
    tcfg = MatryConfig(**base).validate()
    state, model = jstate.init_state(jcfg, jax.random.PRNGKey(2))
    outputs = ("rgba_layers_src_image_ref_image_tgt_image_blend_weights_"
               "alphas_psv_src_output_image_ref_output_image")
    batch = _numpy_batch()
    want = jax.device_get(jcli.build_infer_fn(jcfg, model, outputs,
                                              allow_fused=False)(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()}))
    params = entry.make_params(tcfg, flax_params=jax.tree.map(
        np.asarray, state.params), device="cpu")
    before = tsweep.gather_sweeps
    got = tcli.build_infer_fn(tcfg, params, outputs)(_tbatch(batch))
    assert tsweep.gather_sweeps == before + 1
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k]),
                                   rtol=0, atol=2e-3, err_msg=k)
    hb = _hres_batch(batch)
    args = [hb["hres_ref_image"], hb["hres_src_image"],
            np.asarray(want["blend_weights"]), np.asarray(want["alphas"]),
            batch["ref_pose"], batch["src_pose"], batch["ref_pose_inv"],
            batch["intrinsics"], batch["tgt_pose"]]
    jrgb, jdepth = jcli.build_hres_render_fn(jcfg)(*map(jnp.asarray, args))
    trgb, tdepth = tcli.build_hres_render_fn(tcfg)(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), atol=2e-3)
    np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth), atol=2e-3)


@pytest.mark.parametrize("input_type", ["PP", "REALESTATE_PP"])
def test_use_pallas_false_mpi_request_matches_the_default_route(
        input_type):
    """A PP or RealEstate test-CLI request with use_pallas=false (the
    plain net, the MPI render) equals the default route's (the net
    through the kernels' plain versions on the CPU) to 1e-5: both gather
    the same sweep; the two nets sum in other orders."""
    base = dict(TINY, input_type=input_type, **DEPTHS)
    outs = []
    for use_pallas in (True, False):
        cfg = MatryConfig(**base, use_pallas=use_pallas).validate()
        params = entry.make_params(cfg, seed=3, device="cpu")
        batch = entry.synthetic_batch(cfg, 0, "cpu")
        outs.append(tcli.build_infer_fn(cfg, params, "tgt_image_alphas")(
            batch))
    assert set(outs[0]) == set(outs[1]) == {"output_image", "alphas"}
    for k in outs[0]:
        np.testing.assert_allclose(outs[1][k].numpy(), outs[0][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The train CLI.
# ---------------------------------------------------------------------------

def _fixture(tmp_path):
    from matryodshka_tpu.data import synthetic
    return synthetic.make_ods_fixture(str(tmp_path / "fix"), num_scenes=2,
                                      height=32, width=64)


def _flags(tmp_path, glob_pat, name):
    return ["--image_dir", str(tmp_path / "fix" / "images"),
            "--hres_image_dir", str(tmp_path / "fix" / "images"),
            "--cameras_glob", glob_pat, "--height", "32", "--width", "64",
            "--hres_height", "64", "--hres_width", "128",
            "--num_psv_planes", "4", "--num_msi_planes", "4", "--ngf", "8",
            "--compute_dtype", "float32", "--min_depth", "2",
            "--max_depth", "20", "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--experiment_name", name]


def _pngs(root):
    from PIL import Image
    return {n: np.asarray(Image.open(os.path.join(root, n)), np.int32)
            for n in sorted(os.listdir(root))}


@pytest.mark.parametrize("inference", [False, True])
def test_dry_run_matches_jax(tmp_path, monkeypatch, inference):
    """cli.train --dry_run[_inference] (run from tmp_path: the dumps go to
    dryrun/<experiment_name>) against JAX's run_dry_run on the loader's
    first batch, with tgt_hrestgt supervision (hres_*.png): the same file
    names, every PNG within one level of JAX's. With inference both
    restore the same weights from their own checkpoints."""
    from matryodshka_tpu.training.checkpoint import \
        CheckpointManager as JaxManager
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    glob_pat = _fixture(tmp_path)
    flags = _flags(tmp_path, glob_pat, "d") + ["--supervision",
                                               "tgt_hrestgt"]
    jargs = dict(TINY, **HRES, **DEPTHS, supervision="tgt_hrestgt",
                 cameras_glob=glob_pat,
                 image_dir=str(tmp_path / "fix" / "images"),
                 hres_image_dir=str(tmp_path / "fix" / "images"),
                 checkpoint_dir=str(tmp_path / "jckpt"), experiment_name="d")
    jcfg = JaxConfig(**jargs).validate()
    state, model = jstate.init_state(jcfg, jax.random.PRNGKey(4))
    if inference:
        JaxManager(str(tmp_path / "jckpt" / "d")).save(state)
        tcfg = MatryConfig(**dict(jargs, checkpoint_dir=str(
            tmp_path / "ckpt"))).validate()
        ts = tstate.init_state(tcfg, 0, "cpu")
        ts.net.load_state_dict(weights.from_flax(jax.tree.map(
            np.asarray, state.params)))
        CheckpointManager(str(tmp_path / "ckpt" / "d")).save(ts)
    jtrain.run_dry_run(jcfg, jloader.make_loader(jcfg, training=True),
                       state, model, with_inference=inference,
                       dryrun_dir=str(tmp_path / "jax"))
    monkeypatch.chdir(tmp_path)
    cli_train.main(flags + ["--device", "cpu",
                            "--dry_run_inference" if inference
                            else "--dry_run"])
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "dryrun" / "d")
    assert set(got) == set(want)
    assert "hres_tgt.png" in got and "formatInput_7.png" in got
    assert ("tgt_rendered.png" in got) == ("msi_rgb_03.png" in got) == \
        inference
    for n in want:
        assert got[n].shape == want[n].shape, n
        assert np.abs(got[n] - want[n]).max() <= 1, n


def test_profile_steps_writes_a_trace(tmp_path):
    """--profile_steps 1,2: a Chrome trace of steps 1-2 under
    <checkpoint_dir>/<experiment_name>/profile/, holding events."""
    glob_pat = _fixture(tmp_path)
    cli_train.main(_flags(tmp_path, glob_pat, "p") + [
        "--device", "cpu", "--max_steps", "3", "--summary_freq", "3",
        "--profile_steps", "1,2"])
    prof = tmp_path / "ckpt" / "p" / "profile"
    assert os.listdir(prof) == ["trace_1_2.json"]
    events = json.loads((prof / "trace_1_2.json").read_text())["traceEvents"]
    assert len(events) > 100


@pytest.mark.parametrize("extra", [
    ["--supervision", "tgt_src_ref", "--transform_inverse_reg", "true"],
    ["--supervision", "tgt_hrestgt", "--which_loss", "elpips",
     "--height", "64", "--width", "128", "--hres_height", "128",
     "--hres_width", "256"],
    ["--remat_network", "true", "--param_dtype", "bfloat16"],
    ["--use_pallas", "false", "--supervision", "src_ref"]])
def test_train_cli_runs_the_options(tmp_path, extra):
    """Two steps of cli.train on the fixture with each new option: a
    record a step with a finite loss, and a checkpoint."""
    glob_pat = _fixture(tmp_path)
    cli_train.main(_flags(tmp_path, glob_pat, "o") + [
        "--device", "cpu", "--max_steps", "2", "--summary_freq", "1"]
        + extra)
    recs = [json.loads(line) for line in
            (tmp_path / "ckpt" / "o" / "logs" / "metrics.jsonl")
            .read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    assert os.path.exists(tmp_path / "ckpt" / "o" / "2" / "params.npz")


def test_uv_tables_untouched_by_the_trainer():
    """The trainer's renders gather through their own fields: no
    uv_tables build in a src/ref/hrestgt step."""
    jcfg, tcfg, state, batch, _ = _setup(supervision="tgt_src_ref_hrestgt",
                                         **HRES)
    net = _torch_net(tcfg, state.params)
    before = render_lib.uv_builds
    loss, _ = tstep.make_loss_fn(tcfg, net)(_tbatch(_hres_batch(batch)))
    loss.backward()
    assert render_lib.uv_builds == before and np.isfinite(loss.item())
