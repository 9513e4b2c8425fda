"""The port's E-LPIPS trainer against the JAX package's, on CPU, float32.

* The train step's loss and every parameter gradient with
  which_loss=elpips against `jax.value_and_grad(make_loss_fn(...,
  elpips_fn))`, wrap and coord net, spherical attention on and off, on
  tests/test_torch_train.py's tiny config, batch and volume, at its
  tolerances. JAX's elpips_fn runs the metric jitted at (scale 2, swap)
  and records its draw, which the port's metric replays (the E-LPIPS
  tests' JaxDraws). One level for the four cases compiles the metric
  once; scale 1 would not do for the wrap net without spherical
  attention, whose JAX float32 gradients sit up to 1.6e-4 of a leaf's
  largest magnitude from a float64 evaluation of the same loss there (the
  port's float32 gradients within 1.5e-6 of it).
* Every flag of the repo's ODS E-LPIPS train recipes and of its eval
  recipes parses in the port's CLIs, and the train recipes validate.
* `cli.train --which_loss elpips --device cpu` on the synthetic fixture:
  every metrics record says elpips_calibrated: false.
* `continue_train` resumes the loss's generator: a run cut at step 2 and
  resumed ends where one run of 3 steps ends, bit for bit.
"""

import itertools
import json
import os
import shlex
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.losses import basic as jbasic
from matryodshka_tpu.losses.elpips import api as japi
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.cli import evaluate as cli_evaluate
from matryodshka_tpu_torch.cli import train as cli_train
from matryodshka_tpu_torch.config import MatryConfig, config_from_args
from matryodshka_tpu_torch.data import synthetic
from matryodshka_tpu_torch.losses.elpips import api as tapi
from matryodshka_tpu_torch.training import loop as loop_lib
from matryodshka_tpu_torch.training import state as state_lib
from matryodshka_tpu_torch.training import step as tstep
from test_torch_elpips import JaxDraws, jax_metric, port_draws, \
    write_jax_weights
from test_torch_train import TINY, _assert_grads_close, _setup, _torch_net

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (coord_net, spherical_attention) of each case.
CASES = {"wrap": (False, False), "wrap_spherical": (False, True),
         "coord": (True, False), "coord_spherical": (True, True)}
#: The draw's level and swap; the 32x64 render passes four 2x2 pools at
#: this level.
SCALE_SWAP = (2, True)


@pytest.fixture(scope="module")
def elpips_pair(tmp_path_factory):
    """The JAX trainer's metric (random VGG features) jitted at
    SCALE_SWAP, returning its distances and its recorded draw, and a
    JAX-layout .npz of its weights, which the port's metric loads."""
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
def test_elpips_loss_and_grads_match_jax(elpips_pair, name):
    """Loss to rtol 1e-5, every parameter gradient to 1e-4 of its largest
    magnitude (test_torch_train.py's tolerances; both sides take JAX's
    latitude map)."""
    coord, spherical = CASES[name]
    metric, path = elpips_pair
    kw = dict(which_loss="elpips", coord_net=coord,
              spherical_attention=spherical)
    jcfg, tcfg, state, batch, sweep = _setup(**kw)
    _, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    captured = []

    def elpips_fn(p, t, rng):
        d, draws = metric(p, t, rng)
        captured.append(draws)
        return d

    loss_fn = jstep.make_loss_fn(jcfg, model.apply, elpips_fn)

    def loss_with_draws(params, b, rng):
        captured.clear()
        total, aux = loss_fn(params, b, rng)
        return total, (aux, captured)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jaux, draws)), jgrads = jax.value_and_grad(
        loss_with_draws, has_aux=True)(state.params, jbatch,
                                       jax.random.PRNGKey(1))
    assert len(draws) == 1
    replay = port_draws(draws[0], swap=SCALE_SWAP[1])
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=1), weight_path=path)
    net = _torch_net(tcfg, state.params)
    loss_fn = tstep.make_loss_fn(tcfg, net, sweep=sweep,
                                 elpips=lambda p, t, g: tm(p, t, draws=replay))
    if spherical:
        # JAX's float32 latitude map: E-LPIPS's gradient moves by ~1e-3
        # of some leaves' largest under the port's float64 map's ~1e-4
        # relative difference near the equator (test_torch_train.py
        # holds the two maps)
        loss_fn.sph_w = torch.from_numpy(np.array(jbasic.spherical_weights(
            tcfg.height, tcfg.width)))[None, :, :, None]
    loss, aux = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(aux["reconstruction_loss"].item(),
                               float(jaux["reconstruction_loss"]), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_grads_close(net, jgrads["params"], 1e-4)


def test_elpips_config_validates():
    """The released recipe's config validates (it raised before E-LPIPS
    was ported); elpips_average_over below 1 is refused."""
    cfg = MatryConfig(**TINY, which_loss="elpips", coord_net=True,
                      elpips_average_over=2).validate()
    assert cfg.elpips_weight_path is None and not cfg.elpips_host_scale
    with pytest.raises(ValueError, match="elpips_average_over"):
        MatryConfig(**TINY, which_loss="elpips",
                    elpips_average_over=0).validate()


def _recipe_flags(path):
    """The flags a scripts/*.sh recipe passes, "$@" left out."""
    with open(path) as fh:
        text = fh.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if ln.startswith("python "))
    return [t for t in shlex.split(line)[2:] if t != "$@"]


@pytest.mark.parametrize("recipe", ["ods-wotemp-elpips-coord",
                                    "ods-wotemp-elpips-wocoord",
                                    "ods-temp-elpips-coord"])
def test_train_recipe_flags_parse(recipe):
    """Every flag parses and gives a valid E-LPIPS config; ods-temp's
    turns on transform_inverse_reg."""
    args = cli_train.build_parser().parse_args(
        _recipe_flags(f"{REPO}/scripts/train/{recipe}.sh"))
    assert args.which_loss == "elpips"
    assert args.elpips_weight_path == "elpips_vgg.npz"
    assert args.coord_net == recipe.endswith("-coord")
    cfg = config_from_args(args)
    assert cfg.max_steps == 140000 and cfg.experiment_name == recipe
    assert cfg.transform_inverse_reg == ("wotemp" not in recipe)


@pytest.mark.parametrize("recipe", ["ods-wotemp-elpips-coord-reg",
                                    "ods-wotemp-elpips-coord-video"])
def test_eval_recipe_flags_parse(recipe):
    flags = _recipe_flags(f"{REPO}/scripts/eval/{recipe}.sh")
    args = cli_evaluate.build_parser().parse_args(flags + ["--with_elpips"])
    assert args.result_root == "./test/ods-wotemp-elpips-coord"
    assert args.eval_type == recipe.rsplit("-", 1)[1]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("fix")
    return str(root), synthetic.make_ods_fixture(str(root))


def test_cli_train_elpips_stamps_uncalibrated(tmp_path, fixture, capsys):
    """Two steps of the released recipe's loss and net on the fixture
    (64x128), random features: finite losses, and every record says
    elpips_calibrated: false."""
    root, cams = fixture
    with pytest.warns(UserWarning, match="RANDOM"):
        cli_train.main([
            "--device", "cpu", "--image_dir", os.path.join(root, "images"),
            "--cameras_glob", cams, "--height", "64", "--width", "128",
            "--num_psv_planes", "4", "--num_msi_planes", "4", "--ngf", "8",
            "--max_steps", "2", "--summary_freq", "1",
            "--checkpoint_dir", str(tmp_path), "--experiment_name", "e",
            "--which_loss", "elpips", "--coord_net", "true"])
    assert "RANDOM conv features" in capsys.readouterr().out
    recs = [json.loads(line) for line in
            (tmp_path / "e" / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert r["elpips_calibrated"] is False
        assert np.isfinite(r["total_loss"]) and r["total_loss"] > 0


def _run(tmp_path, max_steps, continue_train=False):
    cfg = entry.flagship_cfg(height=64, width=128, num_psv_planes=4,
                             num_msi_planes=4, ngf=8,
                             compute_dtype="float32", summary_freq=1,
                             which_loss="elpips", max_steps=max_steps,
                             save_latest_freq=1,
                             checkpoint_dir=str(tmp_path),
                             experiment_name="run",
                             continue_train=continue_train)
    state = state_lib.init_state(cfg, 0, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step = tstep.make_train_step(cfg, state.net)
    batches = itertools.repeat(entry.synthetic_batch(cfg, 0, "cpu"))
    return loop_lib.train(cfg, state, step, batches,
                          static_log_fields={"elpips_calibrated": False})


def test_continue_train_resumes_generator(tmp_path):
    """2 steps, then a resumed run to 3, against 3 steps in one run: the
    same parameters, bit for bit, and the same generator state (the third
    step's E-LPIPS draw comes from the restored generator); the generator
    starts from cfg.random_seed."""
    whole = _run(tmp_path / "a", 3)
    _run(tmp_path / "b", 2)
    resumed = _run(tmp_path / "b", 3, continue_train=True)
    assert resumed.step == 3
    assert torch.equal(whole.generator.get_state(),
                       resumed.generator.get_state())
    for (n, p), q in zip(whole.net.named_parameters(),
                         resumed.net.parameters()):
        assert torch.equal(p, q), n
    fresh = torch.Generator().manual_seed(MatryConfig().random_seed)
    cfg = entry.flagship_cfg(height=64, width=128, ngf=8)
    assert torch.equal(state_lib.init_state(cfg, 0, "cpu").generator
                       .get_state(), fresh.get_state())
