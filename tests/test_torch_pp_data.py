"""The port's PP and RealEstate10K data against the JAX package's, on CPU.

* `make_perspective_fixture` and `make_realestate_fixture` write the JAX
  package's files byte for byte at equal arguments.
* `ReplicaPerspectiveLoader` and `RealEstateLoader` yield the JAX loaders'
  batches at one seed, in training order (every augmentation drawn from
  np.random.RandomState(cfg.random_seed) in the JAX call order) and in
  evaluation order: images exactly, poses and intrinsics to 1e-6 (the PP
  midpoint is the port's own slerp, in float32), names equal. Both
  packages' loaders decode through PIL here: the native decoder
  (data/native.py, runtime/matryio.cc; tests/test_torch_native.py holds
  the port's copy to the JAX package's) resizes by its own area filter,
  so it is switched off in both for these comparisons.
* The contract checks of JAX tests/test_data.py:86-215 on the port: the
  RealEstate parser and batch contract, the admission rule, the
  subsequence operations, the perspective loader's midpoint; the loader
  dispatch and device_prefetch carrying the PP keys.

Fixtures are 32x64 (PP) and 12 frames of 32x64 (RealEstate), written once
per module.
"""

import os

import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.data import loader as jloader
from matryodshka_tpu.data import native as jnative
from matryodshka_tpu.data import synthetic as jsynth
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.data import loader as tloader
from matryodshka_tpu_torch.data import native as tnative
from matryodshka_tpu_torch.data import parsers
from matryodshka_tpu_torch.data import synthetic as tsynth

POSE_TOL = 1e-6


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def pp_data(tmp_path_factory):
    """(port root, JAX root, glob of each) of the PP fixture."""
    t = str(tmp_path_factory.mktemp("pp_port"))
    j = str(tmp_path_factory.mktemp("pp_jax"))
    return (t, tsynth.make_perspective_fixture(t, height=32, width=64),
            j, jsynth.make_perspective_fixture(j, height=32, width=64))


@pytest.fixture(scope="module")
def re_data(tmp_path_factory):
    t = str(tmp_path_factory.mktemp("re_port"))
    j = str(tmp_path_factory.mktemp("re_jax"))
    kw = dict(num_seqs=2, frames=12, height=32, width=64)
    return (t, tsynth.make_realestate_fixture(t, **kw),
            j, jsynth.make_realestate_fixture(j, **kw))


@pytest.mark.parametrize("kind", ["pp", "re"])
def test_fixtures_match_jax_byte_for_byte(request, kind):
    t, tglob, j, jglob = request.getfixturevalue(f"{kind}_data")
    assert os.path.relpath(tglob, t) == os.path.relpath(jglob, j)
    got, want = _files(t), _files(j)
    assert sorted(got) == sorted(want) and len(got) > 3
    for name in want:
        assert got[name] == want[name], name


def _cfgs(root, glob_pat, **kw):
    args = dict(height=32, width=64, cameras_glob=glob_pat,
                image_dir=os.path.join(root, "images"), random_seed=11, **kw)
    return JaxConfig(**args), MatryConfig(**args).validate()


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k.endswith("_image"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=POSE_TOL,
                                           err_msg=k)
        else:
            assert g == w, k


@pytest.fixture
def jax_pil(monkeypatch):
    """Both packages' loaders on their PIL decode path."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(tnative, "native_available", lambda: False)


@pytest.mark.parametrize("training", [True, False])
def test_perspective_loader_matches_jax(pp_data, jax_pil, training):
    t, tglob, _, _ = pp_data
    jcfg, tcfg = _cfgs(t, tglob, input_type="PP", batch_size=2)
    jb = jloader.make_loader(jcfg, training=training).batches()
    tb = tloader.make_loader(tcfg, training=training).batches()
    assert isinstance(tloader.make_loader(tcfg),
                      tloader.ReplicaPerspectiveLoader)
    for _ in range(3 if training else 1):
        _assert_batches_equal(next(tb), next(jb))


@pytest.mark.parametrize("training", [True, False])
def test_realestate_loader_matches_jax(re_data, jax_pil, training):
    """Training: three batches of the augmented draws (stride 1-2 of 5
    frames on 12-frame clips, reversal, scale + crop, tgt and ref/src
    picks); evaluation: the middle frames."""
    t, tglob, _, _ = re_data
    jcfg, tcfg = _cfgs(t, tglob, input_type="REALESTATE_PP")
    kw = dict(shuffle_seq_length=5, min_stride=1, max_stride=2)
    jl = jloader.RealEstateLoader(jcfg, training=training, **kw)
    tl = tloader.RealEstateLoader(tcfg, training=training, **kw)
    jb, tb = jl.batches(), tl.batches()
    for _ in range(3 if training else 2):
        _assert_batches_equal(next(tb), next(jb))
    if not training:
        assert next(tb, None) is None and next(jb, None) is None


def test_realestate_parser_and_loader_contract(re_data):
    t, tglob, _, _ = re_data
    seqs = parsers.load_realestate_sequences(tglob)
    assert [s.seq_id for s in seqs] == ["vid0000", "vid0001"]
    assert len(seqs[0]) == 12 and seqs[0].poses.shape == (12, 3, 4)
    _, cfg = _cfgs(t, tglob, input_type="REALESTATE_PP", batch_size=1)
    batch = next(tloader.RealEstateLoader(
        cfg, training=True, shuffle_seq_length=5, min_stride=1,
        max_stride=2).batches())
    assert batch["ref_image"].shape == (1, 32, 64, 3)
    assert batch["intrinsics"].shape == (1, 3, 3)
    assert batch["tgt_pose"].shape == (1, 4, 4)
    np.testing.assert_allclose(
        batch["ref_pose_inv"][0] @ batch["ref_pose"][0], np.eye(4),
        atol=1e-5)
    # the recipe's loader: length-10 windows whatever shuffle_seq_length
    # says, so the 12-frame clips fail the training admission rule
    with pytest.raises(ValueError):
        tloader.make_loader(cfg, training=True)
    assert tloader.make_loader(cfg, training=False).shuffle_seq_length == 10


def test_realestate_admission_rule(re_data):
    """A training clip must fit length n at the largest stride,
    (n-1)*max_stride + 1 frames (reference loader.py:118); evaluation only
    n frames; admitted clips reach every stride in [min, max]."""
    t, tglob, _, _ = re_data
    _, cfg = _cfgs(t, tglob, input_type="REALESTATE_PP")
    ok = tloader.RealEstateLoader(cfg, training=True, shuffle_seq_length=5,
                                  min_stride=1, max_stride=2)
    assert len(ok.sequences) == 2
    with pytest.raises(ValueError):
        tloader.RealEstateLoader(cfg, training=True, shuffle_seq_length=5,
                                 min_stride=1, max_stride=3)
    ev = tloader.RealEstateLoader(cfg, training=False, shuffle_seq_length=5,
                                  min_stride=1, max_stride=3)
    assert len(ev.sequences) == 2
    rng = np.random.RandomState(0)
    ts = list(ok.sequences[0].timestamps)
    strides = set()
    for _ in range(50):
        sub = ok.sequences[0].random_subsequence(rng, 5, 1, 2)
        strides.add(ts.index(sub.timestamps[1]) - ts.index(sub.timestamps[0]))
    assert strides == {1, 2}


def test_realestate_subsequence_ops(re_data):
    _, tglob, _, _ = re_data
    seq = parsers.load_realestate_sequences(tglob)[0]
    sub = seq.subsequence(2, 8, 2)
    assert len(sub) == 3 and sub.timestamps[0] == seq.timestamps[2]
    rev = sub.reverse()
    assert rev.timestamps[0] == sub.timestamps[-1]
    np.testing.assert_array_equal(rev.poses[0], sub.poses[-1])
    assert len(seq.random_subsequence(np.random.RandomState(0), 3, 1,
                                      3)) == 3


def test_perspective_loader_midpoint_and_prefetch(pp_data):
    """The PP poses and K (JAX test_data.py:188-198); the reference frame
    is the slerp midpoint of ref and src; device_prefetch carries every
    array key (interp_pose and ref_pose_inv included) as tensors and the
    names as they are."""
    t, tglob, _, _ = pp_data
    _, cfg = _cfgs(t, tglob, input_type="PP", batch_size=1)
    batch = next(tloader.ReplicaPerspectiveLoader(cfg,
                                                  training=False).batches())
    assert batch["ref_image"].shape == (1, 32, 64, 3)
    np.testing.assert_allclose(batch["src_pose"][0, 0, 3], -0.1, atol=1e-6)
    np.testing.assert_allclose(batch["tgt_pose"][0, 0, 3], -0.05, atol=1e-6)
    np.testing.assert_allclose(batch["intrinsics"][0, 0, 0], 32.0)
    np.testing.assert_allclose(batch["interp_pose"][0, 0, 3], -0.05,
                               atol=1e-6)
    np.testing.assert_allclose(
        batch["ref_pose_inv"][0] @ batch["interp_pose"][0], np.eye(4),
        atol=1e-5)
    got = list(tloader.device_prefetch(
        tloader.ReplicaPerspectiveLoader(cfg, training=False).batches(),
        device="cpu"))
    assert len(got) == 2
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            assert torch.is_tensor(got[0][k]), k
            np.testing.assert_array_equal(got[0][k].numpy(), v)
        else:
            assert got[0][k] == v
