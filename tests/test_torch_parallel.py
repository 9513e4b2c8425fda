"""The port's parallelism (matryodshka_tpu_torch/parallel/) against the
JAX package's, on CPU: gloo process groups of 2 and 4 ranks, each rank a
process started by parallel/mesh.run_ranks with a file store under the
test's tmp_path (no port is opened), every start bounded by a join
timeout; the JAX side runs on the conftest's virtual 8-device CPU mesh.

* partial_composite and combine_partials against JAX's and the full
  over-composite; the layer-stack render's partial mode (its plain
  version here) per block, combined, against the full render;
* render_equirect_view_sharded over 2 and 4 ranks against JAX's over a
  2- and 4-way 'shell' mesh and the port's unsharded render; the test
  CLI's sharded high-res render over the ranks against its one-process
  blocks and its unsharded render;
* one data-parallel step over 2 ranks from the port's seeded parameters
  against the port's single-process step on the global batch and JAX
  make_dp_train_step over 2 devices (the port's loss takes the JAX
  gather sweep's volume, as tests/test_torch_train.py's; against JAX a
  parameter whose gradient is at noise level may take the other sign's
  first Adam step, test_adam_steps_match_jax's rule)
  (JAX's tolerances: loss rtol 1e-4, parameters rtol 2e-4 / atol 2e-5),
  with the pixel loss, with the weight regularizer, and with the weight
  regularizer and E-LPIPS at one fixed draw (the port's FixedDraws, JAX's
  sampler and dropout masks monkeypatched to it: jax_fixed_draws); the
  gradients' norm against both (rtol 1e-4) and against the single-process
  step each summed gradient (relative L2 1e-4), which a gradient mean over
  the ranks would halve for the pixel loss, and a missing 1/K double for
  the mean-type terms (Adam's first step, about lr * sign(grad), would
  not show it);
* steps_per_call=3 against three single steps, and through loop.train;
  the GCN's data-parallel multi step over 2 ranks; entry.dryrun_multichip.

JAX is imported inside the tests only: the ranks import this module to
find their function, and they need none of it.
"""

import copy
import itertools
import json
import warnings

import numpy as np
import pytest
import torch

from matryodshka_tpu_torch import entry, weights
from matryodshka_tpu_torch.cli import test as tcli
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.geometry import icosphere as tico
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.losses.elpips import api as elpips_api
from matryodshka_tpu_torch.ops import render_layers as rl_ops
from matryodshka_tpu_torch.parallel import dp, mesh, sharded_render
from matryodshka_tpu_torch.training import loop as loop_lib
from matryodshka_tpu_torch.training import state as tstate
from matryodshka_tpu_torch.training import step as tstep
from matryodshka_tpu_torch.training.checkpoint import restore_params

torch.set_num_threads(1)

#: Seconds a group of ranks may take before the test fails.
JOIN_TIMEOUT = 120.0
#: Shells at 2-20 m, where the two packages' sweeps park no pixel
#: differently (tests/test_torch_cli.py).
DEPTHS = dict(min_depth=2.0, max_depth=20.0)
TINY = dict(height=32, width=64, num_psv_planes=4, num_msi_planes=4, ngf=8,
            compute_dtype="float32", batch_size=2, **DEPTHS)
DP_CONFIGS = {"pixel": {}, "wreg": dict(wreg=True),
              "elpips_wreg": dict(wreg=True, which_loss="elpips")}
GCN = dict(height=16, width=32, num_psv_planes=3, num_msi_planes=3, ngf=8,
           batch_size=2, gcn=True, subdiv=2, compute_dtype="float32")
HRES = dict(height=16, width=32, num_psv_planes=4, num_msi_planes=4,
            hres_height=32, hres_width=64, compute_dtype="float32",
            min_depth=2.0, max_depth=20.0)


def _render_inputs():
    """The sharded render's inputs (tests/test_parallel.py's)."""
    rng = np.random.RandomState(1)
    h, w, p = 16, 32, 8
    rgba = rng.rand(h, w, p, 4).astype(np.float32)
    radii = np.linspace(100.0, 1.0, p).astype(np.float32)
    return (rgba, np.eye(4, dtype=np.float32),
            np.asarray([0.03, 0.01, -0.02], np.float32), radii)


def _hres_inputs():
    """A high-res re-render's inputs: (cfg, the render's arguments)."""
    cfg = MatryConfig(**HRES).validate()
    rng = np.random.RandomState(2)
    p, h, w = cfg.num_psv_planes, cfg.height, cfg.width

    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32))

    eye = torch.eye(4)[None]
    intr = torch.tensor([[[0.032, 0, 0], [0, 1, 0], [0, 0, 1.0]]])
    return cfg, (t(1, 2 * h, 2 * w, 3), t(1, 2 * h, 2 * w, 3),
                 t(1, h, w, p), t(1, h, w, p), eye, eye, eye, intr,
                 torch.tensor([[0.03, -0.01, 0.02]]))


def _dp_batch():
    """tests/test_train_smoke.py:synthetic_batch of batch 2, as numpy."""
    rng = np.random.RandomState(0)
    b, h, w = TINY["batch_size"], TINY["height"], TINY["width"]

    def img():
        return rng.rand(b, h, w, 3).astype(np.float32)

    eye = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    intr = np.tile(np.asarray([[0.032, 0, 0], [0, 1, 0], [0, 0, 1.0]],
                              np.float32)[None], (b, 1, 1))
    return {"ref_image": img(), "src_image": img(), "tgt_image": img(),
            "ref_pose": eye, "src_pose": eye, "ref_pose_inv": eye,
            "tgt_pose": np.tile(np.asarray([[0.05, 0.0, 0.0]], np.float32),
                                (b, 1)), "intrinsics": intr}


class FixedDraws(elpips_api.Metric):
    """E-LPIPS whose every draw is one fixed global draw for the batch of
    2 (scale level 1, masks filled), or for a batch of one its example
    `rank`'s slice: the same transforms and dropout masks per example in
    the single-process step and on the ranks."""

    def __init__(self, fixed, rank=None):
        super().__init__(elpips_api.elpips_vgg(batch_size=2))
        self.fixed, self.rank = fixed, rank

    def draw(self, batch_size, generator, scale=None, swap=None):
        d = copy.deepcopy(self.fixed)
        if batch_size == 2:
            return d
        r = self.rank
        p = d.params._replace(**{
            k: getattr(d.params, k)[r:r + 1] for k in (
                "offset_xy", "flips", "color_factors", "permutations")})
        return elpips_api.Draw(p, d.seed, [m[r:r + 1] for m in d.masks])


def jax_fixed_draws(monkeypatch, fixed):
    """Make the JAX package's E-LPIPS draw the fixed global draw, as
    FixedDraws does in the port: transforms.sample_ensemble returns its
    transforms and networks._shared_dropout_mask its masks in order (NHWC),
    the whole batch of 2, or under shard_map the 'data' shard's example."""
    import jax
    import jax.numpy as jnp
    from matryodshka_tpu.losses.elpips import networks as jnetworks
    from matryodshka_tpu.losses.elpips import transforms as jtransforms
    p = fixed.params
    per_example = {
        "offset_xy": p.offset_xy.numpy().astype(np.int32),
        "flips": p.flips.numpy().astype(np.int32),
        "color_factors": p.color_factors.numpy().reshape(-1, 1, 1, 3),
        "permutations": p.permutations.numpy().astype(np.int32)}
    masks = [np.ascontiguousarray(m.permute(0, 2, 3, 1).numpy())
             for m in fixed.masks]
    used = []

    def mine(a, batch_size):
        if batch_size == a.shape[0]:
            return jnp.asarray(a)
        return jax.lax.dynamic_slice_in_dim(
            jnp.asarray(a), jax.lax.axis_index("data") * batch_size,
            batch_size, 0)

    def sample(key, batch_size, *a, **k):
        used.clear()
        return jtransforms.EnsembleParams(
            swap_xy=jnp.int32(p.swap_xy),
            scale_offset_xy=jnp.asarray(p.scale_offset_xy.numpy(), jnp.int32),
            scale_level=jnp.int32(p.scale_level),
            **{k2: mine(v, batch_size) for k2, v in per_example.items()})

    def mask(key, shape, keep_prob):
        m = masks[len(used)]
        used.append(m)
        out = mine(m, shape[0])
        assert out.shape == tuple(shape), (out.shape, shape)
        return out

    monkeypatch.setattr(jtransforms, "sample_ensemble", sample)
    monkeypatch.setattr(jnetworks, "_shared_dropout_mask", mask)
    return used


def _fixed_draw(shape):
    """The fixed global draw, its masks filled by one evaluation."""
    metric = elpips_api.Metric(elpips_api.elpips_vgg(batch_size=2))
    d = metric.draw(2, torch.Generator().manual_seed(5), scale=1,
                    swap=False)
    x = torch.rand((2, *shape, 3), generator=torch.Generator().manual_seed(6))
    metric(x, x, draws=[d])
    return d


def _dp_setup(root, name, world):
    """(cfg, net with the saved initial parameters, the JAX gather sweep's
    global volume) of a DP config."""
    cfg = MatryConfig(**TINY, **DP_CONFIGS[name],
                      num_data_shards=world).validate()
    tree, _ = restore_params(str(root / "init.npz"))
    net = tstate.build_model(cfg)
    net.load_state_dict(weights.from_flax(tree))
    vol = torch.from_numpy(np.load(root / "psv.npy"))
    return cfg, net, vol


def _world_worker(rank, world, root):
    """One rank: the sharded views, the CLI's sharded high-res render and,
    over 2 ranks, the DP steps and the GCN's DP multi step; rank 0 saves
    what it got to root/world<world>.npz."""
    out = {}
    rgba, pose, pos, radii = (torch.from_numpy(a) for a in _render_inputs())
    out["view"] = sharded_render.render_equirect_view_sharded(
        rgba, pose, pos, radii).numpy()
    cfg, args = _hres_inputs()
    rgb, depth = tcli.build_hres_render_fn(cfg, shards=world)(*args)
    out["hres_rgb"], out["hres_depth"] = rgb.numpy(), depth.numpy()
    if world == 2:
        batch = {k: torch.from_numpy(v) for k, v in _dp_batch().items()}
        shard = dp.shard_batch(batch, rank, world)
        fixed = torch.load(root / "draw.pt", weights_only=False)
        for name in DP_CONFIGS:
            cfg, net, vol = _dp_setup(root, name, world)
            state = tstate.TrainState(0, net, tstate.build_optimizer(cfg, net),
                                      torch.Generator().manual_seed(0))
            elpips = (FixedDraws(fixed, rank) if cfg.which_loss == "elpips"
                      else None)
            step = dp.make_dp_train_step(
                cfg, net, sweep=lambda c, b, d, v=vol[rank:rank + 1]: v,
                elpips=elpips)
            state, m = step(state, shard)
            out[f"{name}/loss"] = m["total_loss"].numpy()
            out[f"{name}/grad_norm"] = m["grad_norm"].numpy()
            for k, v in net.named_parameters():
                out[f"{name}/{k}"] = v.detach().numpy()
                out[f"{name}/grad/{k}"] = v.grad.numpy()
        gcfg = MatryConfig(**GCN, mesh_dir=str(root / "mesh"),
                           num_data_shards=world).validate()
        state = tstate.init_state(gcfg, 0, "cpu")
        multi = dp.make_dp_train_multi_step(
            gcfg, state.net, gcn_inputs=state.gcn_inputs, steps_per_call=2)
        gb = entry.synthetic_batch(gcfg, 0, "cpu")
        state, m = multi(state, dp.stack_batches(
            [dp.shard_batch(gb, rank, world)] * 2))
        out["gcn_losses"], out["gcn_step"] = m["total_loss"].numpy(), \
            np.asarray(state.step)
    if rank == 0:
        np.savez(root / f"world{world}.npz", **out)


@pytest.fixture(scope="module")
def dp_root(tmp_path_factory):
    """The DP configs' shared inputs, written before the ranks start: the
    JAX init parameters, the JAX gather sweep's global volume, the fixed
    E-LPIPS draw and the GCN's mesh cache."""
    import jax
    import jax.numpy as jnp
    from matryodshka_tpu.geometry import sweep as jsweep
    from matryodshka_tpu.models import msi as jmsi
    from tests.test_train_smoke import tiny_cfg

    root = tmp_path_factory.mktemp("dp")
    jcfg = tiny_cfg(batch_size=2, **DEPTHS)
    tree = weights.seeded_init(MatryConfig(**TINY), 0)
    np.savez(root / "init.npz", **{
        f"params/{layer}/{leaf}": v for layer, leaves in tree["params"].items()
        for leaf, v in leaves.items()})
    b = _dp_batch()
    depths = jnp.asarray(jsweep.inv_depths(jcfg.min_depth, jcfg.max_depth,
                                           jcfg.num_psv_planes))
    psv = np.asarray(jax.jit(jsweep.format_network_input)(
        jmsi.preprocess_image(b["ref_image"]),
        jmsi.preprocess_image(b["src_image"]), b["ref_pose"], b["src_pose"],
        b["ref_pose_inv"], depths, b["intrinsics"]))
    np.save(root / "psv.npy", np.ascontiguousarray(psv.transpose(0, 3, 1, 2)))
    torch.save(_fixed_draw((TINY["height"], TINY["width"])),
               root / "draw.pt")
    tico.load_mesh_input(GCN["subdiv"], GCN["height"], GCN["width"],
                         str(root / "mesh"))
    return root


@pytest.fixture(scope="module")
def world2(dp_root):
    mesh.run_ranks(_world_worker, 2, str(dp_root / "store2"),
                   args=(dp_root,), timeout=JOIN_TIMEOUT)
    return dict(np.load(dp_root / "world2.npz"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("w4")
    mesh.run_ranks(_world_worker, 4, str(root / "store"), args=(root,),
                   timeout=JOIN_TIMEOUT)
    return dict(np.load(root / "world4.npz"))


# ---------------------------------------------------------------------------
# The partials.
# ---------------------------------------------------------------------------

def test_partial_composite_and_combine_match_jax_and_full():
    import jax.numpy as jnp
    from matryodshka_tpu.parallel import sharded_render as jsr
    rng = np.random.RandomState(0)
    rgba = rng.rand(6, 8, 12, 4).astype(np.float32)
    rgba[:, :, 0, 3] = 1.0
    full = render_lib.over_composite(torch.from_numpy(rgba)).numpy()
    cs, ts, jcs, jts = [], [], [], []
    for g in range(4):
        part = rgba[:, :, g * 3:(g + 1) * 3]
        c, t = sharded_render.partial_composite(torch.from_numpy(part))
        jc, jt = jsr.partial_composite(jnp.asarray(part))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6)
        cs.append(c)
        ts.append(t)
        jcs.append(jc)
        jts.append(jt)
    out = sharded_render.combine_partials(torch.stack(cs),
                                          torch.stack(ts)).numpy()
    np.testing.assert_allclose(out, np.asarray(jsr.combine_partials(
        jnp.stack(jcs), jnp.stack(jts))), atol=1e-6)
    np.testing.assert_allclose(out, full, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_partial_mode_blocks_combine_to_the_full_render(blocks):
    """The layer-stack render's partial mode (CPU: its plain version) per
    block of shells, combined, against render_layers_both of the whole
    stack: 1e-5 (the render-layer gates); one block is the full render."""
    rng = np.random.RandomState(3)
    p, h, w = 8, 16, 32
    stack = torch.from_numpy(rng.rand(1, p, h, w, 4).astype(np.float32))
    pose, pos = torch.eye(4)[None], torch.tensor([[0.02, -0.01, 0.03]])
    radii = torch.linspace(20.0, 2.0, p)
    want = rl_ops.render_layers_both(stack, pose, pos, radii)
    parts = [rl_ops.render_layers_partial(stack[:, p0:p1].contiguous(),
                                          pose, pos, radii[p0:p1], p0, p)
             for p0, p1 in sharded_render.shell_blocks(p, blocks)]
    c, d, t = (torch.stack(x) for x in zip(*parts))
    for got, ref in ((sharded_render.combine_partials(c, t), want[0]),
                     (sharded_render.combine_partials(d, t), want[1])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5)
    assert t.shape == (blocks, 1, h, w, 1)


def test_shell_blocks():
    assert sharded_render.shell_blocks(8, 4) == [(0, 2), (2, 4), (4, 6),
                                                 (6, 8)]
    with pytest.raises(ValueError, match="split evenly"):
        sharded_render.shell_blocks(32, 3)


# ---------------------------------------------------------------------------
# Across ranks.
# ---------------------------------------------------------------------------

def _jax_sharded_view(n):
    import jax.numpy as jnp
    from matryodshka_tpu.parallel import mesh as jmesh
    from matryodshka_tpu.parallel import sharded_render as jsr
    import jax
    rgba, pose, pos, radii = _render_inputs()
    m = jmesh.make_mesh(data=1, shell=n)
    fn = jax.jit(lambda *a: jsr.render_equirect_view_sharded(*a, m))
    return np.asarray(fn(jnp.asarray(rgba), jnp.asarray(pose),
                         jnp.asarray(pos), jnp.asarray(radii)))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render_matches_jax_and_unsharded(world, request):
    got = request.getfixturevalue(f"world{world}")
    rgba, pose, pos, radii = (torch.from_numpy(a) for a in _render_inputs())
    full = render_lib.render_equirect_view(rgba, pose, pos, radii).numpy()
    np.testing.assert_allclose(got["view"], _jax_sharded_view(world),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["view"], full, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_cli_sharded_hres_render_matches_unsharded(world, request):
    """The test CLI's high-res re-render over the ranks (each its block
    through the partial mode, the partials all_gathered) against the same
    blocks in one process and the unsharded render: 1e-5."""
    got = request.getfixturevalue(f"world{world}")
    cfg, args = _hres_inputs()
    whole = tcli.build_hres_render_fn(cfg)(*args)
    blocks = tcli.build_hres_render_fn(cfg, shards=world)(*args)
    for i, k in enumerate(("hres_rgb", "hres_depth")):
        np.testing.assert_allclose(got[k], blocks[i].numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got[k], whole[i].numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(DP_CONFIGS))
def test_dp_step_matches_single_and_jax(name, dp_root, world2, monkeypatch):
    """The 2-rank step against the single-process step on the global
    batch (the same volume, draws and initial parameters) and against JAX
    make_dp_train_step over 2 devices, whose E-LPIPS draws the same fixed
    draw per example (jax_fixed_draws)."""
    cfg, net, vol = _dp_setup(dp_root, name, 1)
    state = tstate.TrainState(0, net, tstate.build_optimizer(cfg, net),
                              torch.Generator().manual_seed(0))
    fixed = torch.load(dp_root / "draw.pt", weights_only=False)
    elpips = FixedDraws(fixed) if cfg.which_loss == "elpips" else None
    step = tstep.make_train_step(cfg, net, sweep=lambda c, b, d: vol,
                                 elpips=elpips)
    batch = {k: torch.from_numpy(v) for k, v in _dp_batch().items()}
    state, m = step(state, batch)
    np.testing.assert_allclose(world2[f"{name}/loss"],
                               m["total_loss"].item(), rtol=1e-4)
    # the summed gradient is the global batch's (a mean over the ranks
    # would halve the pixel loss's, and without the 1/K the mean-type
    # terms' would double)
    np.testing.assert_allclose(world2[f"{name}/grad_norm"],
                               m["grad_norm"].item(), rtol=1e-4)
    for k, v in net.named_parameters():
        g = world2[f"{name}/grad/{k}"]
        rel = np.linalg.norm(g - v.grad.numpy()) / max(
            float(v.grad.norm()), 1e-30)
        assert rel <= 1e-4, (k, rel)
        np.testing.assert_allclose(world2[f"{name}/{k}"],
                                   v.detach().numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    import jax
    from matryodshka_tpu.losses.elpips import api as japi
    from matryodshka_tpu.parallel import dp as jdp
    from matryodshka_tpu.parallel import mesh as jmesh
    from matryodshka_tpu.training import state as jstate
    from tests.test_train_smoke import tiny_cfg
    jelpips, used = None, []
    if cfg.which_loss == "elpips":
        used = jax_fixed_draws(monkeypatch, fixed)
        with warnings.catch_warnings():     # random conv features
            warnings.simplefilter("ignore")
            jm = japi.Metric(japi.elpips_vgg(batch_size=2))

        def jelpips(p, t, rng):
            return jm.forward(p, t, rng, static_scale_swap=(
                int(fixed.params.scale_level), bool(fixed.params.swap_xy)))
    jcfg = tiny_cfg(batch_size=2, **DEPTHS, **DP_CONFIGS[name])
    tree, _ = restore_params(str(dp_root / "init.npz"))
    params = jax.tree.map(jax.numpy.asarray, tree)
    tx = jstate.build_optimizer(jcfg)
    jst = jstate.TrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                            params=params, opt_state=tx.init(params))
    m2 = jmesh.make_mesh(data=2)
    jstep = jdp.make_dp_train_step(jcfg, jstate.build_model(jcfg).apply, tx,
                                   m2, elpips_fn=jelpips, donate=False)
    js, jm = jstep(jst, jdp.shard_batch(_dp_batch(), m2),
                   jax.random.PRNGKey(7))
    if jelpips is not None:    # JAX's E-LPIPS took every mask of the draw
        assert len(used) == len(fixed.masks)
    np.testing.assert_allclose(world2[f"{name}/loss"],
                               float(jm["total_loss"]), rtol=1e-4)
    np.testing.assert_allclose(world2[f"{name}/grad_norm"],
                               float(jm["grad_norm"]), rtol=1e-4)
    # JAX's tolerances, and 2 * lr where the gradient is at noise level
    # (below 1e-6 of its leaf's largest): Adam's first step is about
    # lr * sign(grad), and such a sign may flip between the packages
    # (tests/test_torch_train.py:test_adam_steps_match_jax)
    want = weights.from_flax(jax.tree.map(np.asarray, js.params))
    for k, v in net.named_parameters():
        g = v.grad.abs()
        tol = torch.where(g < 1e-6 * g.max(), 2 * cfg.learning_rate,
                          2e-5 + 2e-4 * want[k].abs())
        err = (torch.from_numpy(world2[f"{name}/{k}"]) - want[k]).abs()
        assert bool((err <= tol).all()), (k, float(err.max()))


def test_gcn_dp_multi_step_runs(world2):
    """The GCN under the 2-rank multi step (batch 1 a rank, as JAX's
    shard_map gives it): two finite losses, step 2."""
    assert world2["gcn_losses"].shape == (2,)
    assert np.all(np.isfinite(world2["gcn_losses"]))
    assert int(world2["gcn_step"]) == 2


def test_dryrun_multichip():
    entry.dryrun_multichip(2)


# ---------------------------------------------------------------------------
# Chained steps and the rank generators.
# ---------------------------------------------------------------------------

def _tiny_state(**kw):
    cfg = entry.flagship_cfg(**dict(TINY, batch_size=1), **kw)
    return cfg, tstate.init_state(cfg, 0, "cpu")


def _batches(cfg, n):
    out = []
    for i in range(n):
        b = entry.synthetic_batch(cfg, 0, "cpu")
        b["ref_image"] = b["ref_image"] + 0.01 * i
        out.append(b)
    return out


def test_steps_per_call_matches_sequential_steps():
    """make_dp_train_multi_step(steps_per_call=3) on three stacked batches
    against three calls of the single step: the same losses and
    parameters, bit for bit (one process, the same operations)."""
    cfg, s_seq = _tiny_state()
    _, s_multi = _tiny_state()
    batches = _batches(cfg, 3)
    single = tstep.make_train_step(cfg, s_seq.net)
    losses = []
    for b in batches:
        s_seq, m = single(s_seq, b)
        losses.append(m["total_loss"].item())
    multi = dp.make_dp_train_multi_step(cfg, s_multi.net, steps_per_call=3)
    s_multi, mm = multi(s_multi, dp.stack_batches(batches))
    assert s_multi.step == s_seq.step == 3
    assert mm["total_loss"].shape == (3,)
    np.testing.assert_array_equal(mm["total_loss"].numpy(),
                                  np.asarray(losses, np.float32))
    for a, b in zip(s_seq.net.parameters(), s_multi.net.parameters()):
        assert torch.equal(a, b)


def test_loop_steps_per_call_matches_single(tmp_path):
    """loop.train with steps_per_call=2 against steps_per_call=1 on one
    batch stream for 4 steps: the same parameters, a metrics record per
    step and the checkpoints at the calls that crossed save_latest_freq
    (JAX tests/test_parallel.py:test_loop_steps_per_call_matches_single)."""
    results = {}
    for k in (1, 2):
        cfg, state = _tiny_state(max_steps=4, summary_freq=2,
                                 save_latest_freq=3,
                                 checkpoint_dir=str(tmp_path),
                                 experiment_name=f"k{k}")
        step = tstep.make_train_step(cfg, state.net)
        results[k] = loop_lib.train(cfg, state, step,
                                    itertools.cycle(_batches(cfg, 3)),
                                    steps_per_call=k)
        recs = (tmp_path / f"k{k}" / "logs" / "metrics.jsonl").read_text()
        assert [json.loads(r)["step"] for r in recs.splitlines()] == [2, 4]
    assert results[1].step == results[2].step == 4
    for a, b in zip(results[1].net.parameters(), results[2].net.parameters()):
        assert torch.equal(a, b)
    steps = sorted(int(d.name) for d in (tmp_path / "k2").iterdir()
                   if d.name.isdigit())
    assert steps == [4]


def test_rank_generators_and_shards():
    a = dp.rank_generator(8964, 3, 0)
    b = dp.rank_generator(8964, 3, 1)
    c = dp.rank_generator(8964, 3, 0)
    x = torch.rand(4, generator=a)
    assert not torch.equal(x, torch.rand(4, generator=b))
    assert torch.equal(x, torch.rand(4, generator=c))
    batch = {"a": np.arange(6).reshape(6, 1), "t": torch.arange(6),
             "scene_id": ["s"] * 6}
    shard = dp.shard_batch(batch, 1, 3)
    assert sorted(shard) == ["a", "t"]
    assert shard["a"].ravel().tolist() == [2, 3]
    assert shard["t"].tolist() == [2, 3]
    stacked = dp.stack_batches([shard, shard])
    assert stacked["t"].shape == (2, 2)
