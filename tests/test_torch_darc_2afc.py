"""The port's darc archive and 2AFC harness (matryodshka_tpu_torch/losses/
elpips/{darc,train_2afc}.py), mirroring tests/test_darc_2afc.py, on CPU:
round trip, append, torn-write repair; an archive written by either
package read by the other, and the same appends giving the same bytes;
the ranking head against the JAX package's; and 2AFC training beating
chance."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.losses.elpips import darc as jdarc
from matryodshka_tpu.losses.elpips import train_2afc as j2afc
from matryodshka_tpu_torch.losses.elpips import train_2afc
from matryodshka_tpu_torch.losses.elpips.darc import DataArchive

torch.set_num_threads(1)


def _arrays():
    rng = np.random.RandomState(0)
    return [rng.rand(4, 5).astype(np.float32),
            rng.randint(0, 255, (3, 2, 2), dtype=np.uint8),
            np.asarray(0.75, np.float32)]


def test_darc_roundtrip(tmp_path):
    path = str(tmp_path / "test.darc")
    arrays = _arrays()
    with DataArchive(path, "w") as db:
        for i, a in enumerate(arrays):
            db.append(a, f"item/{i}")
    with DataArchive(path, "r") as db:
        assert len(db) == 3
        assert db.keys() == [f"item/{i}" for i in range(3)]
        for i, a in enumerate(arrays):
            np.testing.assert_array_equal(db.read(f"item/{i}"), a)
            np.testing.assert_array_equal(db[i], a)
        assert [k for k, _ in db.items()] == db.keys()


def test_darc_append_mode(tmp_path):
    path = str(tmp_path / "test.darc")
    with DataArchive(path, "w") as db:
        db.append(np.zeros(3, np.float32), "a")
    with DataArchive(path, "a") as db:
        db.append(np.ones(3, np.float32), "b")
    with DataArchive(path, "r") as db:
        assert db.keys() == ["a", "b"]
        np.testing.assert_array_equal(db.read("b"), np.ones(3))


def test_darc_repair_torn_write(tmp_path):
    path = str(tmp_path / "torn.darc")
    with DataArchive(path, "w") as db:
        db.append(np.arange(6, dtype=np.float32), "x")
        db.append(np.arange(4, dtype=np.float32), "y")
    # chop off the directory (a crash before close)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 40)
    with DataArchive(path, "r") as db:
        assert "x" in db.keys()
        np.testing.assert_array_equal(db.read("x"),
                                      np.arange(6, dtype=np.float32))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_darc_archives_cross_packages(tmp_path, writer):
    """The same appends through either package give the same bytes, and
    each package reads (and appends to) the other's archive."""
    w_cls, r_cls = ((jdarc.DataArchive, DataArchive) if writer == "jax"
                    else (DataArchive, jdarc.DataArchive))
    arrays = _arrays()
    paths = {}
    for name, cls in (("mine", w_cls), ("other", r_cls)):
        paths[name] = str(tmp_path / f"{name}.darc")
        with cls(paths[name], "w") as db:
            for i, a in enumerate(arrays):
                db.append(a, f"item/{i}")
    with open(paths["mine"], "rb") as fa, open(paths["other"], "rb") as fb:
        assert fa.read() == fb.read()
    with r_cls(paths["mine"], "a") as db:
        db.append(np.full(2, 7, np.int64), "extra")
    with w_cls(paths["mine"], "r") as db:
        assert db.keys() == [f"item/{i}" for i in range(3)] + ["extra"]
        for i, a in enumerate(arrays):
            np.testing.assert_array_equal(db.read(f"item/{i}"), a)
        np.testing.assert_array_equal(db.read("extra"), np.full(2, 7))


def test_ranking_head_matches_jax():
    """ranking_logit and the BCE ranking loss on the same head parameters
    and distances as the JAX package's: within 1e-6 relative."""
    rng = np.random.RandomState(3)
    head = {k: (0.1 * rng.randn(*s)).astype(np.float32) for k, s in (
        ("W1", (5, 32)), ("b1", (32,)), ("W2", (32, 32)), ("b2", (32,)),
        ("W3", (32, 1)), ("b3", (1,)))}
    d0, d1 = (rng.rand(8).astype(np.float32) for _ in range(2))
    judge = (rng.rand(8) > 0.5).astype(np.float32)
    jhead = {k: jnp.asarray(v) for k, v in head.items()}
    thead = {k: torch.from_numpy(v) for k, v in head.items()}
    want = np.asarray(j2afc.ranking_logit(jhead, jnp.asarray(d0),
                                          jnp.asarray(d1)))
    got = train_2afc.ranking_logit(thead, torch.from_numpy(d0),
                                   torch.from_numpy(d1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = float(j2afc.bce_ranking_loss(jhead, jnp.asarray(d0),
                                        jnp.asarray(d1), jnp.asarray(judge)))
    got = float(train_2afc.bce_ranking_loss(
        thead, torch.from_numpy(d0), torch.from_numpy(d1),
        torch.from_numpy(judge)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    init = train_2afc.init_head_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: v.shape for k, v in head.items()}


def test_2afc_training_learns_ranking(tmp_path):
    """With judgements following true L2-closeness, training must beat
    chance accuracy even from random VGG features."""
    rng = np.random.RandomState(0)
    triplets = []
    for i in range(16):
        ref = rng.rand(32, 32, 3).astype(np.float32)
        n0 = rng.randn(32, 32, 3).astype(np.float32)
        n1 = rng.randn(32, 32, 3).astype(np.float32)
        # p0 mildly distorted, p1 heavily -> judges prefer p0 (judge=0)
        p0 = np.clip(ref + 0.05 * n0, 0, 1)
        p1 = np.clip(ref + 0.4 * n1, 0, 1)
        if i % 2 == 0:
            p0, p1 = p1, p0
            judge = 1.0
        else:
            judge = 0.0
        triplets.append((ref, p0, p1, judge))
    path = str(tmp_path / "2afc.darc")
    train_2afc.make_archive(path, triplets)

    cfg = train_2afc.TrainConfig(batch_size=8, steps=60,
                                 learning_rate=3e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lin, head, metrics = train_2afc.train(
            cfg, train_2afc.archive_batches(path, cfg.batch_size),
            verbose=False, device="cpu")
    assert metrics["accuracy"] > 0.7, metrics
    assert set(lin) == {f"lin{i}.model.1.weight" for i in range(5)}
    assert lin["lin0.model.1.weight"].shape == (1, 1, 64, 1)
    assert all(v.min() >= 0 for v in lin.values())
