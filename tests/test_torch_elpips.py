"""The port's E-LPIPS (matryodshka_tpu_torch/losses/elpips) against the JAX
package's, on CPU, float32, 64x64 seeded images.

jax.random and the port's torch.Generator draw different ensembles, so
every comparison replays the JAX package's draws: `JaxDraws` records the
transforms and dropout masks a JAX call makes (a traced call returns them
among its outputs), and `port_draws` hands them to the port's
`Metric.forward(draws=...)`. The JAX metric runs at a fixed
`static_scale_swap`, one branch, jitted.

* each transform, at every flip code, both swaps, offsets 0 and
  offset_max and scales 1-8 with every scale offset: bit for bit;
* the VGG and SqueezeNet taps (both variants each, dropout on, JAX's
  weights through weights.elpips_from_jax): within 1e-5 of each tap's
  largest magnitude;
* Metric.forward at four (scale, swap) values, in tuple mode with
  average_over 2, and the plain LPIPS config: within 1e-5 relative; its
  gradient with respect to the image against jax.grad: relative L2 1e-4;
* load_weights on a JAX-layout .npz and without one, and the packaged
  linear weights byte for byte;
* the sampler's distributions over many draws.
"""

import filecmp
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.losses.elpips import api as japi
from matryodshka_tpu.losses.elpips import networks as jnetworks
from matryodshka_tpu.losses.elpips import transforms as jtransforms
from matryodshka_tpu_torch.losses.elpips import api as tapi
from matryodshka_tpu_torch.losses.elpips import networks as tnetworks
from matryodshka_tpu_torch.losses.elpips import transforms as ttransforms
from matryodshka_tpu_torch.weights import elpips_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class JaxDraws:
    """Records the JAX package's E-LPIPS draws while its code runs: each
    transforms.sample_ensemble call opens a draw, each shared dropout mask
    joins the latest. A traced function returns `self.draws` (reset with
    `clear`) among its outputs to bring them out as arrays."""

    def __init__(self, monkeypatch):
        self.draws = []
        sample, mask = (jtransforms.sample_ensemble,
                        jnetworks._shared_dropout_mask)

        def rec_sample(*a, **k):
            p = sample(*a, **k)
            self.draws.append((p, []))
            return p

        def rec_mask(*a):
            m = mask(*a)
            self.draws[-1][1].append(m)
            return m

        monkeypatch.setattr(jtransforms, "sample_ensemble", rec_sample)
        monkeypatch.setattr(jnetworks, "_shared_dropout_mask", rec_mask)

    def clear(self):
        self.draws = []


def _long(a):
    return torch.from_numpy(np.array(a, np.int64))


def port_params(p, swap=None) -> ttransforms.EnsembleParams:
    """The port's EnsembleParams of a JAX draw (swap replaced if given)."""
    return ttransforms.EnsembleParams(
        offset_xy=_long(p.offset_xy), flips=_long(p.flips),
        swap_xy=int(p.swap_xy) if swap is None else int(swap),
        color_factors=torch.from_numpy(
            np.array(p.color_factors, np.float32).reshape(-1, 3)),
        permutations=_long(p.permutations),
        scale_offset_xy=_long(p.scale_offset_xy),
        scale_level=int(p.scale_level))


def port_draws(jax_draws, swap=None):
    """tapi.Draws replaying recorded JAX draws (NHWC masks -> NCHW)."""
    return [tapi.Draw(port_params(p, swap), 0,
                      [torch.from_numpy(np.array(m)).permute(0, 3, 1, 2)
                       .contiguous() for m in masks])
            for p, masks in jax_draws]


def write_jax_weights(jmetric, path) -> str:
    """An .npz in the JAX package's layout holding jmetric's weights."""
    blob = {f"net/{k}": np.asarray(v) for k, v in jmetric.network.net.w.items()}
    blob.update({f"lin/{k}": np.asarray(v)
                 for k, v in jmetric.network.lin.items()})
    np.savez(path, **blob)
    return str(path)


def jax_metric(config):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return japi.Metric(config)


def _images(n=2, h=64, w=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(n, h, w, 3).astype(np.float32) for _ in range(3)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel_close(got, want, rtol, what=""):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    scale = float(np.max(np.abs(np.asarray(want))))
    assert err <= rtol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# Transforms.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swap", [False, True])
def test_transforms_match_jax_exactly(swap):
    """apply_ensemble (downscale, offset, flips, swap, colour permutation
    and factors) on four samples, one per flip code, with offsets 0,
    offset_max and between, at every scale 1-8 and each of its scale
    offsets: equal bit for bit."""
    om = 7
    x = _images(4)[0]
    params = jtransforms.EnsembleParams(
        offset_xy=jnp.asarray([[0, 0], [om, om], [0, om], [3, 5]]),
        flips=jnp.asarray([0, 1, 2, 3]), swap_xy=jnp.asarray(int(swap)),
        color_factors=jnp.asarray(
            np.random.RandomState(1).uniform(0.2, 1.0, (4, 1, 1, 3)),
            jnp.float32),
        permutations=jnp.asarray([[2, 0, 1], [1, 2, 0], [0, 2, 1],
                                  [2, 1, 0]]),
        scale_offset_xy=jnp.zeros(2, jnp.int32),
        scale_level=jnp.asarray(1))
    apply = jax.jit(jtransforms.apply_ensemble,
                    static_argnums=(2, 3, 4, 5, 6))
    for scale in range(1, 9):
        for oy in range(scale):
            for ox in range(scale):
                p = params._replace(scale_offset_xy=jnp.asarray([oy, ox]),
                                    scale_level=jnp.asarray(scale))
                want = np.asarray(apply(jnp.asarray(x), p, scale, om, True,
                                        True, swap))
                got = ttransforms.apply_ensemble(
                    _nchw(x), port_params(p), scale, om, swap=swap)
                np.testing.assert_array_equal(_nhwc(got), want,
                                              err_msg=f"{scale} {oy} {ox}")
    # offset and scale switched off: flips, swap and colour alone
    p = params._replace(scale_level=jnp.asarray(4))
    want = np.asarray(apply(jnp.asarray(x), p, 4, om, False, False, swap))
    got = ttransforms.apply_ensemble(_nchw(x), port_params(p), 4, om,
                                     enable_offset=False,
                                     enable_scale=False, swap=swap)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_sampler_distributions():
    """sample_ensemble over 6,000 draws of a batch of 6: scale ~ 1/i^2,
    swap ~ Bernoulli(0.5), offsets uniform in [0, offset_max], scale
    offsets below the level; in every draw each flip code at most twice
    (the stratified arange % 4), each colour stratum [i/n, (i+1)/n) once
    per channel, factors 0.2 + 0.8 c, all six permutations. Then
    sample_scale_swap_host's (scale, swap) and a static scale."""
    g = torch.Generator().manual_seed(0)
    probs = tapi.elpips_vgg().scale_probabilities
    n, draws = 6, 6000
    levels, swaps, offsets = [], [], []
    for _ in range(draws):
        p = ttransforms.sample_ensemble(g, n, 7, probs)
        levels.append(p.scale_level)
        swaps.append(p.swap_xy)
        offsets.append(p.offset_xy)
        so = p.scale_offset_xy
        assert bool(((so >= 0) & (so < p.scale_level)).all())
        assert torch.bincount(p.flips, minlength=4).max() <= 2
        # sorted, channel c's i-th value lies in [i/n, (i+1)/n) (up to the
        # float32 rounding of 0.2 + 0.8 c and back)
        cn = torch.sort((p.color_factors - 0.2) / 0.8 * n, dim=0).values
        lo = torch.arange(n, dtype=torch.float32)[:, None]
        assert bool(((cn > lo - 1e-4) & (cn < lo + 1 + 1e-4)).all()), cn
        assert {tuple(r) for r in p.permutations.tolist()} == {
            (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
            (2, 1, 0)}
    want = np.asarray(probs) / np.sum(probs)
    got = np.bincount(levels, minlength=9)[1:] / draws
    # binomial standard error at 6,000 draws is <= 0.0065: 4 of them
    np.testing.assert_allclose(got, want, atol=0.026)
    assert abs(np.mean(swaps) - 0.5) < 0.026
    off = torch.stack(offsets).flatten()
    np.testing.assert_allclose(torch.bincount(off, minlength=8).numpy()
                               / off.numel(), np.full(8, 1 / 8), atol=0.005)
    # the flip codes of a batch of 4 are a permutation of 0-3, at every
    # position equally often
    firsts = [int(ttransforms.sample_ensemble(g, 4, 7, probs).flips[0])
              for _ in range(2000)]
    np.testing.assert_allclose(np.bincount(firsts, minlength=4) / 2000,
                               np.full(4, 0.25), atol=0.04)
    assert sorted(ttransforms.sample_ensemble(g, 4, 7, probs).flips
                  .tolist()) == [0, 1, 2, 3]
    assert ttransforms.sample_ensemble(g, 1, 7, probs,
                                       static_scale=5).scale_level == 5
    rng = np.random.RandomState(0)
    host = [ttransforms.sample_scale_swap_host(rng, tapi.elpips_vgg())
            for _ in range(draws)]
    got = np.bincount([s for s, _ in host], minlength=9)[1:] / draws
    np.testing.assert_allclose(got, want, atol=0.026)
    assert abs(np.mean([sw for _, sw in host]) - 0.5) < 0.026
    assert ttransforms.sample_scale_swap_host(rng, tapi.lpips_vgg()) == (
        1, False)


# ---------------------------------------------------------------------------
# Feature towers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower,variant", [("vgg", "full_avg"),
                                           ("vgg", "lpips"),
                                           ("squeeze", "lpips"),
                                           ("squeeze", "full_maxpool")])
def test_taps_match_jax(monkeypatch, tower, variant):
    """Every tap of a two-image tuple, dropout on (JAX's masks replayed,
    one shared mask per conv input), JAX's random weights: within 1e-5 of
    the tap's largest magnitude."""
    rec = JaxDraws(monkeypatch)
    if tower == "vgg":
        w = jnetworks.random_vgg_weights(jax.random.PRNGKey(1))
        jnet = jnetworks.VGG16Features(w, variant, use_dropout=True)
        tnet = tnetworks.VGG16Features(elpips_from_jax(w), variant,
                                       use_dropout=True)
    else:
        w = jnetworks.random_squeeze_weights(jax.random.PRNGKey(1))
        jnet = jnetworks.SqueezeNetFeatures(w, variant, use_dropout=True)
        tnet = tnetworks.SqueezeNetFeatures(elpips_from_jax(w), variant,
                                            use_dropout=True)
    a, b, _ = _images(2)

    def run(a, b, key):
        rec.clear()
        rec.draws.append((None, []))
        taps = jnet((a, b), key)
        return taps, rec.draws[0][1]

    taps, masks = jax.jit(run)(jnp.asarray(a), jnp.asarray(b),
                               jax.random.PRNGKey(2))
    draw = tapi.Draw(None, 0, [torch.from_numpy(np.array(m))
                               .permute(0, 3, 1, 2) for m in masks])
    got = tnet((_nchw(a), _nchw(b)), draw.dropout(0.99))
    assert len(got) == len(taps) == len(tnet.tap_channels)
    assert len(draw.masks) == len(masks) > 0
    for i, (gt, jt) in enumerate(zip(got, taps)):
        for k in range(2):
            _rel_close(_nhwc(gt[k]), jt[k], 1e-5, f"tap {i} image {k}")


# ---------------------------------------------------------------------------
# The metric.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    """The JAX E-LPIPS VGG metric and its weights as a JAX-layout .npz."""
    jm = jax_metric(japi.elpips_vgg(batch_size=2))
    path = write_jax_weights(jm, tmp_path_factory.mktemp("w") / "vgg.npz")
    return jm, path


@pytest.mark.parametrize("scale_swap", [(1, False), (2, True), (5, False),
                                        (8, True)])
def test_metric_matches_jax(monkeypatch, vgg_pair, scale_swap):
    """Metric.forward at one (scale, swap), JAX's draw replayed: within
    1e-5 relative per distance."""
    jm, path = vgg_pair
    rec = JaxDraws(monkeypatch)
    a, ref, _ = _images(2)

    def run(a, ref):
        rec.clear()
        d = jm.forward(a, ref, jax.random.PRNGKey(3),
                       static_scale_swap=scale_swap)
        return d, rec.draws

    want, draws = jax.jit(run)(jnp.asarray(a), jnp.asarray(ref))
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=2), weight_path=path)
    got = tm(torch.from_numpy(a), torch.from_numpy(ref),
             draws=port_draws(draws, swap=scale_swap[1]))
    assert tm.calibrated and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_metric_tuple_mode_average_over_2(monkeypatch, vgg_pair):
    """Two candidates under identical transforms, the mean of two draws
    (average_over=2), at (3, True): each distance within 1e-5 relative."""
    jm, path = vgg_pair
    jm2 = japi.Metric(japi.elpips_vgg(batch_size=2, n=2), weight_path=path)
    rec = JaxDraws(monkeypatch)
    a, b, ref = _images(2, seed=4)

    def run(a, b, ref):
        rec.clear()
        d = jm2.forward((a, b), ref, jax.random.PRNGKey(5),
                        static_scale_swap=(3, True))
        return d, rec.draws

    want, draws = jax.jit(run)(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(ref))
    assert len(draws) == 2
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=2, n=2), weight_path=path)
    got = tm((torch.from_numpy(a), torch.from_numpy(b)),
             torch.from_numpy(ref), draws=port_draws(draws, swap=True))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_metric_grad_matches_jax(monkeypatch, vgg_pair):
    """d mean(distance) / d image against jax.grad at (2, True), JAX's
    draw replayed: relative L2 1e-4."""
    jm, path = vgg_pair
    rec = JaxDraws(monkeypatch)
    a, ref, _ = _images(2, seed=6)

    def loss(a, ref):
        rec.clear()
        d = jm.forward(a, ref, jax.random.PRNGKey(7),
                       static_scale_swap=(2, True))
        return jnp.mean(d), rec.draws

    (_, draws), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(a), jnp.asarray(ref))
    tm = tapi.Metric(tapi.elpips_vgg(batch_size=2), weight_path=path)
    x = torch.from_numpy(a).requires_grad_(True)
    tm(x, torch.from_numpy(ref), draws=port_draws(draws, swap=True)
       ).mean().backward()
    want = np.asarray(want)
    rel = np.linalg.norm(x.grad.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_lpips_vgg_matches_jax(tmp_path):
    """The plain LPIPS config (no transforms, no dropout, the 5-tap VGG
    with 3x3/2 max pooling): within 1e-5 relative."""
    jm = jax_metric(japi.lpips_vgg(batch_size=2))
    path = write_jax_weights(jm, tmp_path / "lpips.npz")
    a, ref, _ = _images(2, seed=8)
    want = jax.jit(lambda a, r: jm.forward(a, r, jax.random.PRNGKey(0)))(
        jnp.asarray(a), jnp.asarray(ref))
    tm = tapi.Metric(tapi.lpips_vgg(batch_size=2), weight_path=path)
    got = tm(torch.from_numpy(a), torch.from_numpy(ref),
             generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_draw_replays_its_masks():
    """A draw sampled from a generator fills its masks on first use (the
    shared dropout of keep 0.99: values 0 and 1/0.99, ~1% zeros); the same
    Draw then gives the same distance, and so does one rebuilt from its
    params and masks; another generator state gives another value."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = tapi.Metric(tapi.elpips_vgg(batch_size=1))
    a, ref, _ = (torch.from_numpy(x) for x in _images(1, seed=9))
    g = torch.Generator().manual_seed(0)
    draw = tm.draw(1, g, scale=2, swap=True)
    assert draw.params.scale_level == 2 and draw.params.swap_xy == 1
    d1 = tm(a, ref, draws=[draw])
    assert len(draw.masks) == 13
    m = torch.cat([x.flatten() for x in draw.masks])
    assert set(torch.unique(m).tolist()) == {0.0, float(
        torch.tensor(1.0) / torch.tensor(0.99))}
    assert abs(float((m == 0).float().mean()) - 0.01) < 0.001
    again = tapi.Draw(draw.params, seed=12345, masks=list(draw.masks))
    assert torch.equal(tm(a, ref, draws=[draw]), d1)
    assert torch.equal(tm(a, ref, draws=[again]), d1)
    assert not torch.equal(tm(a, ref, generator=g), d1)


# ---------------------------------------------------------------------------
# Weights.
# ---------------------------------------------------------------------------

def test_load_weights_round_trip_and_packaged(vgg_pair):
    """load_weights on a JAX-layout .npz: the conv weights through
    elpips_from_jax (OIHW, bit for bit), its linear weights, calibrated;
    without a path: a warning, the packaged linear weights, calibrated
    False; the packaged files are the JAX package's, byte for byte."""
    jm, path = vgg_pair
    net, lin, calibrated = tapi.load_weights(path, "vgg_ensemble")
    assert calibrated
    assert set(net) == set(jm.network.net.w)
    for k, v in jm.network.net.w.items():
        v = np.asarray(v)
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        np.testing.assert_array_equal(net[k].numpy(), want)
    for k, v in jm.network.lin.items():
        np.testing.assert_array_equal(lin[k], np.asarray(v))
    with pytest.warns(UserWarning, match="RANDOM"):
        net, lin, calibrated = tapi.load_weights(None, "vgg")
    assert not calibrated and net["28.weight"].shape == (512, 512, 3, 3)
    for metric, name in tapi._PACKAGED_LIN.items():
        assert filecmp.cmp(
            os.path.join(REPO, "matryodshka_tpu_torch/losses/elpips/"
                         "weights", name),
            os.path.join(REPO, "matryodshka_tpu/losses/elpips/weights",
                         name), shallow=False)
        want = japi.packaged_lin_weights(metric)
        got = tapi.packaged_lin_weights(metric)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
