"""The port's evaluator (matryodshka_tpu_torch/evaluation/metrics.py and
cli/evaluate.py) against the JAX package's, on CPU.

* SSIM, PSNR, the edge-padded blur, the temporal diff and remove_pole on
  seeded images of odd sizes;
* `main` against the JAX package's `main` on one directory of PNGs, in
  reg mode with E-LPIPS (both on the same random VGG weights, given as a
  JAX-layout .npz; the port replays the draw of the JAX evaluator's
  PRNGKey(0)), reg with --remove_pole, and video mode: the same keys, and
  values within 1e-5;
* the refusal of random features without --allow_uncalibrated, their
  stamp with it, and --device cuda raising where there is no card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from matryodshka_tpu.cli import evaluate as jevaluate
from matryodshka_tpu.evaluation import metrics as jmetrics
from matryodshka_tpu.losses.elpips import api as japi
from matryodshka_tpu.losses.elpips import transforms as jtransforms
from matryodshka_tpu_torch.cli import evaluate as tevaluate
from matryodshka_tpu_torch.evaluation import metrics as tmetrics
from matryodshka_tpu_torch.losses.elpips import api as tapi
from test_torch_elpips import JaxDraws, jax_metric, port_draws, \
    write_jax_weights

torch.set_num_threads(1)
H, W = 64, 96


@pytest.mark.parametrize("shape", [(37, 53, 3), (64, 91, 3), (45, 45, 1)])
def test_metrics_match_jax(shape):
    """Float32 sums in other orders: SSIM within 1e-6, PSNR within 1e-5
    dB, the blur within 1e-6 of the image's range, the temporal diff
    within 1e-7; remove_pole crops the same rows."""
    rng = np.random.RandomState(sum(shape))
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(tmetrics.ssim(ta, tb)) - float(jmetrics.ssim(ja, jb))) \
        <= 1e-6
    assert abs(float(tmetrics.psnr(ta, tb)) - float(jmetrics.psnr(ja, jb))) \
        <= 1e-5
    np.testing.assert_allclose(tmetrics.gaussian_blur(ta).numpy(),
                               np.asarray(jmetrics.gaussian_blur(ja)),
                               rtol=0, atol=1e-6)
    assert abs(float(tmetrics.temporal_diff(ta, tb))
               - float(jmetrics.temporal_diff(ja, jb))) <= 1e-7
    np.testing.assert_array_equal(tmetrics.remove_pole(a),
                                  jmetrics.remove_pole(a))


def _png(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def result_root(tmp_path_factory):
    """Three examples and three consecutive video frames in the test CLI's
    layout: tgt_image / output_tgt (and output_depth) PNGs."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W] / np.float32(W)
    for i, name in enumerate(["scene00_000102", "scene01_101112",
                              "scene02_202122"]):
        gt = np.stack([np.sin(3 * xx + i), np.cos(4 * yy), xx * yy], -1)
        gt = 0.5 + 0.4 * gt
        _png(f"{root}/{name}/tgt_image_{name}.png", gt)
        _png(f"{root}/{name}/output_tgt_{name}.png",
             gt + 0.05 * (i + 1) * rng.randn(H, W, 3))
    for k in range(3):
        name = f"video_scene00_00{k}"
        frame = 0.5 + 0.4 * np.sin(5 * xx + 0.2 * k + 2 * yy)
        _png(f"{root}/{name}/output_tgt_{name}.png",
             np.repeat(frame[..., None], 3, -1) + 0.02 * rng.randn(H, W, 3))
        _png(f"{root}/{name}/output_depth_{name}.png",
             np.repeat((yy + 0.1 * k)[..., None], 3, -1))
    return str(root)


def _assert_same_json(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        elif k == "per_example":
            assert len(g) == len(w)
            for ge, we in zip(g, w):
                assert list(ge) == list(we)
                for kk, vv in we.items():
                    if isinstance(vv, float):
                        np.testing.assert_allclose(ge[kk], vv, rtol=1e-5,
                                                   err_msg=kk)
                    else:
                        assert ge[kk] == vv
        elif k != "result_root":
            assert g == w, k


@pytest.mark.parametrize("mode", ["reg_elpips", "reg_remove_pole", "video"])
def test_main_matches_jax(monkeypatch, tmp_path, result_root, mode):
    """Both mains on the same PNGs. With E-LPIPS, the JAX evaluator draws
    in-graph from PRNGKey(0) (its metric cut to 2 scale levels, as
    tests/test_elpips.py cuts it, so its lax.switch compiles 4 branches);
    the port replays that draw, recorded from a jitted call at the drawn
    (scale, swap), whose key use matches the switch's."""
    flags = {"reg_elpips": ["--with_elpips"],
             "reg_remove_pole": ["--remove_pole"],
             "video": ["--eval_type", "video"]}[mode]
    if mode == "reg_elpips":
        config = japi.elpips_vgg(batch_size=1)
        config.num_scales = 2
        monkeypatch.setattr(japi, "elpips_vgg", lambda batch_size=1: config)
        jm = jax_metric(config)
        flags += ["--elpips_weight_path",
                  write_jax_weights(jm, tmp_path / "vgg.npz")]
        k_ens = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    0))[0]
        drawn = jtransforms.sample_ensemble(k_ens, 1, config.offset_max,
                                            config.scale_probabilities)
        scale_swap = (int(drawn.scale_level), bool(drawn.swap_xy))
        rec = JaxDraws(monkeypatch)
        img = jnp.zeros((1, H, W, 3))

        def run(a):
            rec.clear()
            jm.forward(a, a, jax.random.PRNGKey(0),
                       static_scale_swap=scale_swap)
            return rec.draws

        (draw,) = port_draws(jax.jit(run)(img), swap=scale_swap[1])
        monkeypatch.setattr(
            tapi.Metric, "draw",
            lambda self, n, g, scale=None, swap=None: tapi.Draw(
                draw.params, 0, list(draw.masks)))
    jevaluate.main(["--result_root", result_root, "--output_json",
                    str(tmp_path / "jax.json")] + flags)
    got = tevaluate.main(["--result_root", result_root, "--output_json",
                          str(tmp_path / "torch.json"), "--device", "cpu"]
                         + flags)
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == json.loads((tmp_path / "torch.json").read_text())
    _assert_same_json(got, want)
    if mode == "reg_elpips":
        assert got["elpips_calibrated"] is True
        assert len(got["per_example"]) == 3 and "avg_elpips" in got
    if mode == "video":
        assert "avg_depth_diff" in got


def test_main_refuses_random_features(tmp_path, result_root):
    """--with_elpips without weights exits with a usage error unless
    --allow_uncalibrated, which stamps elpips_calibrated: false;
    --device cuda raises where there is no card."""
    base = ["--result_root", result_root, "--with_elpips", "--device",
            "cpu", "--output_json", str(tmp_path / "out.json")]
    with pytest.warns(UserWarning, match="RANDOM"), \
            pytest.raises(SystemExit):
        tevaluate.main(base)
    with pytest.warns(UserWarning, match="RANDOM"):
        out = tevaluate.main(base + ["--allow_uncalibrated"])
    assert out["elpips_calibrated"] is False
    assert np.isfinite(out["avg_elpips"]) and out["avg_elpips"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tevaluate.main(["--result_root", result_root])
