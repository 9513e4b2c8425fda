"""The port's training loop, checkpoints, batch prefetch, fixture and
training CLI, on CPU.

* `training/loop.train` with `summary_freq` / `save_latest_freq`, and a
  run cut at step 2 and resumed with `continue_train` against one run of 3
  steps: the same parameters and optimizer state, bit for bit;
* `cli.train --device cpu` for 3 steps on the synthetic fixture, whose
  checkpoint the port's test CLI then serves, from `--params` and, as the
  JAX CLI does, from the latest checkpoint when `--params` is absent (and
  raises when there is none); `--device cuda` raises on a machine without
  a card; four chained steps a call (`steps_per_call`);
* `OdsLoader(load_hres=True)` reading the high-res pair from
  `hres_image_dir`;
* `data.loader.device_prefetch` and `data.synthetic` against the JAX
  package's copy.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.data import synthetic
from matryodshka_tpu_torch.data.loader import device_prefetch
from matryodshka_tpu_torch.training import loop as loop_lib
from matryodshka_tpu_torch.training import state as state_lib
from matryodshka_tpu_torch.training.checkpoint import CheckpointManager, \
    restore_params
from matryodshka_tpu_torch.training.step import make_train_step

torch.set_num_threads(1)

TINY = dict(height=32, width=64, num_psv_planes=4, num_msi_planes=4, ngf=8,
            compute_dtype="float32", summary_freq=1)


def _run(tmp_path, max_steps, continue_train=False, save_latest_freq=1):
    cfg = entry.flagship_cfg(**TINY, max_steps=max_steps,
                             save_latest_freq=save_latest_freq,
                             checkpoint_dir=str(tmp_path),
                             experiment_name="run",
                             continue_train=continue_train)
    state = state_lib.init_state(cfg, 0, "cpu")
    batches = itertools.repeat(entry.synthetic_batch(cfg, 0, "cpu"))
    return loop_lib.train(cfg, state, make_train_step(cfg, state.net),
                          batches)


def test_loop_summaries_and_checkpoints(tmp_path):
    state = _run(tmp_path, 3, save_latest_freq=2)
    assert state.step == 3
    ckpt = tmp_path / "run"
    assert CheckpointManager(str(ckpt)).steps() == [2, 3]
    recs = [json.loads(line) for line in
            (ckpt / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert set(recs[0]) == {"step", "total_loss", "reconstruction_loss",
                            "grad_norm", "sec_per_step"}
    tree, step = restore_params(str(ckpt / "3" / "params.npz"))
    assert step == 3
    sd = state.net.state_dict()
    k = tree["params"]["conv1_1"]["kernel"]
    np.testing.assert_array_equal(k, sd["conv1_1.weight"].permute(
        2, 3, 1, 0).numpy())


def test_continue_train_resumes_bit_exact(tmp_path):
    """2 steps, then a resumed run to 3, against 3 steps in one run: the
    same parameters and Adam moments (one batch, repeated; CPU math repeats
    exactly)."""
    whole = _run(tmp_path / "a", 3)
    _run(tmp_path / "b", 2)
    resumed = _run(tmp_path / "b", 3, continue_train=True)
    assert resumed.step == 3
    for (n, p), q in zip(whole.net.named_parameters(),
                         resumed.net.parameters()):
        assert torch.equal(p, q), n
    sa = whole.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]), i


def test_checkpoint_max_to_keep(tmp_path):
    cfg = entry.flagship_cfg(**TINY)
    state = state_lib.init_state(cfg, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in range(1, 6):
        state.step = s
        mgr.save(state)
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_device_prefetch_cpu():
    """Arrays become tensors with the same values, other entries pass
    through, a loader error reaches the consumer, and closing early stops
    the thread."""
    arrays = [{"x": np.full((2, 3), i, np.float32), "ids": [str(i)]}
              for i in range(5)]
    got = list(device_prefetch(iter(arrays), size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert b["ids"] == [str(i)]

    def failing():
        yield arrays[0]
        raise OSError("bad jpeg")

    it = device_prefetch(failing(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="bad jpeg"):
        next(it)

    def endless():
        while True:
            yield arrays[1]

    it = device_prefetch(endless(), size=1, device="cpu")
    next(it)
    it.close()


def test_erp_texture_matches_jax_copy():
    from matryodshka_tpu.data import synthetic as jsynthetic
    np.testing.assert_array_equal(synthetic.erp_texture(16, 32, seed=3),
                                  jsynthetic.erp_texture(16, 32, seed=3))


def test_cli_train_cpu_then_test_cli_serves_it(tmp_path):
    """3 steps of the training CLI on the fixture (summaries every step,
    images included), then the test CLI on its last checkpoint."""
    from matryodshka_tpu_torch.cli import test as test_cli
    from matryodshka_tpu_torch.cli import train as train_cli
    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=32, width=64)
    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", "32", "--width", "64",
             "--num_psv_planes", "4", "--num_msi_planes", "4", "--ngf", "8",
             "--experiment_name", "t", "--device", "cpu"]
    train_cli.main(flags + ["--max_steps", "3", "--summary_freq", "1",
                            "--checkpoint_dir", str(tmp_path / "ckpt")])
    ckpt = tmp_path / "ckpt" / "t"
    assert CheckpointManager(str(ckpt)).latest_step() == 3
    logs = ckpt / "logs"
    assert len((logs / "metrics.jsonl").read_text().splitlines()) == 3
    assert (logs / "output_image_00000003.png").exists()
    test_cli.main(flags + ["--params", str(ckpt / "3" / "params.npz"),
                           "--output_root", str(tmp_path / "out"),
                           "--num_runs", "1"])
    out = tmp_path / "out" / "t"
    assert (out / "step.txt").read_text() == "3"
    dirs = [d for d in os.listdir(out) if (out / d).is_dir()]
    assert len(dirs) == 1
    alphas = np.load(out / dirs[0] / "alphas.npy")
    assert alphas.shape == (1, 32, 64, 4) and np.isfinite(alphas).all()


def test_test_cli_restores_latest_checkpoint(tmp_path):
    """cli.train writes <ckpt>/t/3/; cli.test with the same flags and no
    --params restores it (step.txt 3) and writes the same files, byte for
    byte, as the run with --params <ckpt>/t/3/params.npz."""
    from matryodshka_tpu_torch.cli import test as test_cli
    from matryodshka_tpu_torch.cli import train as train_cli
    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=32, width=64)
    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", "32", "--width", "64",
             "--num_psv_planes", "4", "--num_msi_planes", "4", "--ngf", "8",
             "--experiment_name", "t", "--device", "cpu",
             "--checkpoint_dir", str(tmp_path / "ckpt")]
    train_cli.main(flags + ["--max_steps", "3", "--summary_freq", "3"])
    params = tmp_path / "ckpt" / "t" / "3" / "params.npz"
    for out, extra in (("latest", []), ("params", ["--params", str(params)])):
        test_cli.main(flags + extra + ["--output_root", str(tmp_path / out),
                                       "--num_runs", "1"])
    got, want = tmp_path / "latest" / "t", tmp_path / "params" / "t"
    assert (got / "step.txt").read_text() == "3"
    names = sorted(os.path.relpath(os.path.join(d, f), want)
                   for d, _, fs in os.walk(want) for f in fs)
    assert any(n.endswith("alphas.npy") for n in names)
    assert names == sorted(os.path.relpath(os.path.join(d, f), got)
                           for d, _, fs in os.walk(got) for f in fs)
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_test_cli_without_checkpoint_raises(tmp_path):
    """No --params and no checkpoint under <checkpoint_dir>/<experiment>:
    FileNotFoundError, as the JAX CLI raises, before any output."""
    from matryodshka_tpu_torch.cli import test as test_cli
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        test_cli.main(["--checkpoint_dir", str(tmp_path / "ckpt"),
                       "--experiment_name", "t", "--device", "cpu",
                       "--output_root", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_loader_reads_hres_image_dir(tmp_path):
    """load_hres=True reads the 4096x2048 pair's files (here 64x128) from
    hres_image_dir under image_dir's names: a copy of the fixture with
    inverted pixels comes back inverted, the low-res images do not."""
    from matryodshka_tpu_torch.data import images as img_lib
    from matryodshka_tpu_torch.data.loader import OdsLoader
    glob_pat = synthetic.make_ods_fixture(str(tmp_path), num_scenes=1,
                                          height=32, width=64)
    lo, hi = tmp_path / "images", tmp_path / "hres"
    hi.mkdir()
    for f in os.listdir(lo):
        px = np.round(255 * img_lib.load_and_resize(str(lo / f), 32, 64))
        img_lib.write_image(str(hi / f), (255 - px).astype(np.uint8))
    cfg = entry.flagship_cfg(**TINY, cameras_glob=glob_pat,
                             image_dir=str(lo), hres_image_dir=str(hi),
                             hres_height=64, hres_width=128)
    batch = next(OdsLoader(cfg, training=False, load_hres=True).batches())
    for k, iid in zip(("ref", "src", "tgt"), batch["image_ids"][0]):
        name = f"{batch['scene_id'][0]}_pos{iid}.jpeg"
        np.testing.assert_array_equal(
            batch[f"hres_{k}_image"][0],
            img_lib.load_and_resize(str(hi / name), 64, 128))
        np.testing.assert_array_equal(
            batch[f"{k}_image"][0],
            img_lib.load_and_resize(str(lo / name), 32, 64))
        from_lo = img_lib.load_and_resize(str(lo / name), 64, 128)
        assert np.abs(batch[f"hres_{k}_image"][0] - from_lo).mean() > 0.1


def test_cli_train_refuses_cuda_without_card(tmp_path):
    from matryodshka_tpu_torch.cli import train as train_cli
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--checkpoint_dir", str(tmp_path)])
    # steps_per_call=4: the four steps in one call, each logged, the
    # checkpoint at the call's end
    cfg = entry.flagship_cfg(**TINY, max_steps=4, save_latest_freq=4,
                             checkpoint_dir=str(tmp_path),
                             experiment_name="spc")
    state = state_lib.init_state(cfg, 0, "cpu")
    step = make_train_step(cfg, state.net)
    state = loop_lib.train(cfg, state, step, itertools.repeat(
        entry.synthetic_batch(cfg, 0, "cpu")), steps_per_call=4)
    assert state.step == 4
    assert CheckpointManager(str(tmp_path / "spc")).steps() == [4]
    recs = (tmp_path / "spc" / "logs" / "metrics.jsonl").read_text()
    assert [json.loads(r)["step"] for r in recs.splitlines()] == [1, 2, 3, 4]
