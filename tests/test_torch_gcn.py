"""The port's GCN variant against the JAX package's, on CPU, float32, at
the sizes of tests/test_gcn.py (subdiv 2-3, 16x32, 3 planes, ngf 8):

* geometry/icosphere.py, the port's copy: vertices, faces, supports and
  the p2v table bit for bit (the vectorised table and the loop
  reference), and load_mesh_input's cache, which either package reads
  from the other's file;
* SparseSupport.matmul, GCNNet with bridged weights, mesh_to_equirect and
  gcn_sphere_sweep within 1e-5; the weight bridge both ways bit for bit
  and seeded_init's tree against flax's shapes and init range;
* infer_gcn_msi's GCN outputs and rgba_layers within 1e-5, per colour
  scheme (its pixel-grid PSV within the sweeps' f32 noise);
* one GCN train step's loss within 1e-5 relative and every gradient
  within relative L2 1e-4 of jax.value_and_grad of the JAX loss (both
  sides take the JAX gather sweep's volume, as tests/test_torch_train.py
  does), and a few Adam steps through the train CLI;
* the test CLI with --gcn true against the JAX CLI: build_infer_fn per
  scheme (the port's kernel route on the CPU: the sweep kernel's plain
  version and the renders' plain versions) and main() end to end. Shells
  at 2-20 m, as tests/test_torch_cli.py, where the two sweeps park no
  pixel differently; so do infer_gcn_msi's and the train step's (the
  JAX test_gcn.py's 1-100 m would hold the two gather sweeps' far-shell
  park flips, ROADMAP Queue 3, not the GCN).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.cli import test as jcli
from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.geometry import icosphere as jico
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import gcn as jgcn
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu.training import step as jstep
from matryodshka_tpu_torch import entry, weights
from matryodshka_tpu_torch.cli import test as tcli
from matryodshka_tpu_torch.cli import train as tcli_train
from matryodshka_tpu_torch.config import COLOR_PREDS, MatryConfig
from matryodshka_tpu_torch.geometry import icosphere as tico
from matryodshka_tpu_torch.geometry import sweep as tsweep
from matryodshka_tpu_torch.models import gcn as tgcn
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.training import state as tstate
from matryodshka_tpu_torch.training import step as tstep

torch.set_num_threads(1)

H, W, P, NGF, SUBDIV = 16, 32, 3, 8, 2
DEPTHS = dict(min_depth=2.0, max_depth=20.0)
TOL = 1e-5


def _cfgs(tmp_path, **kw):
    base = dict(height=H, width=W, num_psv_planes=P, num_msi_planes=P,
                ngf=NGF, batch_size=1, gcn=True, subdiv=SUBDIV,
                mesh_dir=str(tmp_path), compute_dtype="float32", **kw)
    return JaxConfig(**base).validate(), MatryConfig(**base).validate()


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    eye = np.eye(4, dtype=np.float32)[None]
    intr = np.asarray([[[0.032, 0, 0], [0, 1, 0], [0, 0, 1.0]]], np.float32)
    return {"ref_image": rs.rand(1, H, W, 3).astype(np.float32),
            "src_image": rs.rand(1, H, W, 3).astype(np.float32),
            "tgt_image": rs.rand(1, H, W, 3).astype(np.float32),
            "ref_pose": eye, "src_pose": eye, "ref_pose_inv": eye,
            "tgt_pose": np.asarray([[0.03, 0.0, 0.0]], np.float32),
            "intrinsics": intr}


def _jax_gcn(jcfg):
    """(flax params of the seeded JAX GCN, its model, coords, p2v)."""
    state, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    _, coords, p2v = jstate.build_gcn(jcfg)
    return state.params, model, coords, p2v


def _torch_gcn(tcfg, params):
    net, coords, p2v = tstate.build_gcn(tcfg, "cpu")
    net.load_state_dict(weights.gcn_from_flax(
        jax.tree.map(np.asarray, params)))
    return net, coords, p2v


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subdiv", [0, 1, 2, 3])
def test_icosphere_and_supports_bit_exact(subdiv):
    verts, faces = tico.icosphere(subdiv)
    jverts, jfaces = jico.icosphere(subdiv)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    for got, want in zip(tico.support_matrices(verts, faces),
                         jico.support_matrices(jverts, jfaces)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("subdiv, h, w", [(2, 16, 32), (3, 16, 32),
                                          (2, 24, 48)])
def test_p2v_bit_exact(subdiv, h, w):
    """The vectorised table and the loop reference, against JAX's."""
    verts, faces = tico.icosphere(subdiv)
    got = tico.pixel_to_vertex_lookup(verts, faces, h, w)
    np.testing.assert_array_equal(got, jico.pixel_to_vertex_lookup(
        verts, faces, h, w))
    if subdiv == 2 and h == 16:
        np.testing.assert_array_equal(
            tico._pixel_to_vertex_lookup_loop(verts, faces, h, w),
            jico._pixel_to_vertex_lookup_loop(verts, faces, h, w))


def test_load_mesh_input_cache_shared(tmp_path):
    """The port writes sphere{subdiv}_{H}x{W}.npz, JAX reads it, and the
    other way round; every array equal to a fresh generation."""
    a, b = tmp_path / "torch", tmp_path / "jax"
    got = tico.load_mesh_input(SUBDIV, H, W, str(a))
    assert (a / f"sphere{SUBDIV}_{H}x{W}.npz").exists()
    want = jico.load_mesh_input(SUBDIV, H, W, str(b))
    for cache_of, reader in ((a, jico), (b, tico)):
        coords, sups, p2v = reader.load_mesh_input(SUBDIV, H, W,
                                                   str(cache_of))
        np.testing.assert_array_equal(coords, want[0])
        np.testing.assert_array_equal(p2v, want[2])
        for s, w in zip(sups, want[1]):
            for x, y in zip(s, w):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[2], want[2])


# ---------------------------------------------------------------------------
# The GCN's modules.
# ---------------------------------------------------------------------------

def test_sparse_support_matmul_matches_jax():
    verts, faces = tico.icosphere(1)
    rows, cols, vals = tico.support_matrices(verts, faces)[1]
    x = np.random.RandomState(1).rand(len(verts), 5).astype(np.float32)
    got = tgcn.SparseSupport(rows, cols, vals, len(verts)).matmul(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jgcn.SparseSupport(rows, cols, vals, len(verts))
                      .matmul(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    ident = tico.support_matrices(verts, faces)[0]
    assert tgcn.SparseSupport(*ident, len(verts)).is_identity
    assert not tgcn.SparseSupport(rows, cols, vals, len(verts)).is_identity


def test_gcn_net_matches_jax_and_bridge_round_trips(tmp_path):
    jcfg, tcfg = _cfgs(tmp_path)
    params, model, _, _ = _jax_gcn(jcfg)
    net, coords, _ = _torch_gcn(tcfg, params)
    x = np.random.RandomState(2).uniform(
        -1, 1, (len(coords), tcfg.num_net_inputs())).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (len(coords), tcfg.num_net_outputs())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    tree = jax.tree.map(np.asarray, params)
    back = weights.gcn_to_flax(weights.gcn_from_flax(tree))
    assert back["params"].keys() == tree["params"].keys()
    for layer, leaves in tree["params"].items():
        assert back["params"][layer].keys() == leaves.keys()
        for leaf, v in leaves.items():
            got_leaf = back["params"][layer][leaf]
            assert got_leaf.dtype == v.dtype
            np.testing.assert_array_equal(got_leaf, v)


def test_seeded_init_matches_flax_tree(tmp_path):
    """The seeded tree has flax's layers, leaves and shapes; each weight
    lies in flax's uncentred [0, 2r) and the biases are zero; the forward
    recentres it (W - r), so its mean is near 0 after the recentring."""
    jcfg, tcfg = _cfgs(tmp_path)
    params, _, _, _ = _jax_gcn(jcfg)
    tree = weights.seeded_init(tcfg, 0)["params"]
    flax = params["params"]
    assert tree.keys() == flax.keys()
    for layer, leaves in flax.items():
        assert tree[layer].keys() == leaves.keys()
        for leaf, v in leaves.items():
            assert tree[layer][leaf].shape == v.shape, (layer, leaf)
            if leaf.startswith("weights_"):
                r = tgcn.glorot_range(*v.shape)
                assert 0.0 <= tree[layer][leaf].min()
                assert tree[layer][leaf].max() < 2 * r
                assert abs(tree[layer][leaf].mean() - r) < 0.2 * r
            else:
                assert not tree[layer][leaf].any()
    net, _, _ = tstate.build_gcn(tcfg, "cpu")
    net.load_state_dict(weights.gcn_from_flax(tree))
    with torch.no_grad():
        centred = net.conv2_0.weights_1 - net.conv2_0.init_range
    assert abs(float(centred.mean())) < 0.1 * net.conv2_0.init_range


def test_mesh_to_equirect_matches_jax():
    verts, faces = tico.icosphere(3)
    p2v = tico.pixel_to_vertex_lookup(verts, faces, H, W)
    colors = np.random.RandomState(4).randn(len(verts), 6).astype(np.float32)
    got = tgcn.mesh_to_equirect(torch.from_numpy(colors),
                                torch.from_numpy(p2v)).numpy()
    want = np.asarray(jgcn.mesh_to_equirect(jnp.asarray(colors),
                                            jnp.asarray(p2v)))
    assert got.shape == (1, H, W, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("order", [1, -1])
def test_gcn_sphere_sweep_matches_jax(order):
    verts, _ = tico.icosphere(SUBDIV)
    rs = np.random.RandomState(5)
    image = rs.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    intr = np.tile(np.asarray([[0.032, 0, 0], [0, 1, 0], [0, 0, 1]],
                              np.float32), (2, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    want = np.asarray(jsweep.gcn_sphere_sweep(
        jnp.asarray(image), order, jnp.asarray(depths), jnp.asarray(verts),
        jnp.asarray(pose), jnp.asarray(intr)))
    got = tsweep.gcn_sphere_sweep(torch.from_numpy(image), order,
                                  torch.from_numpy(depths),
                                  torch.from_numpy(verts),
                                  torch.from_numpy(intr)).numpy()
    assert got.shape == (2, len(verts), P * 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("scheme", COLOR_PREDS)
def test_infer_gcn_msi_matches_jax(tmp_path, scheme):
    """The GCN's outputs (alphas, blend weights) within 1e-5 of JAX
    infer_gcn_msi's; its pixel-grid PSV (the two gather sweeps) within the
    f32 projection noise at 20 m (2e-3, tests/test_torch_cli.py); and
    rgba_layers within 1e-5 of JAX assemble_rgba of the JAX GCN's
    prediction on the port's PSV."""
    jcfg, tcfg = _cfgs(tmp_path, which_color_pred=scheme, **DEPTHS)
    params, model, coords, p2v = _jax_gcn(jcfg)
    net, tcoords, tp2v = _torch_gcn(tcfg, params)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    depths = jsweep.inv_depths(jcfg.min_depth, jcfg.max_depth, P)
    want = jmsi.infer_gcn_msi(model.apply, params, jcfg, jbatch,
                              jnp.asarray(depths), coords, p2v)
    with torch.no_grad():
        got = tmsi.infer_gcn_msi(
            net, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.tensor(depths, dtype=torch.float32), tcoords, tp2v)
    assert sorted(got) == sorted(want)
    for k in ("alphas", "blend_weights", "bg_rgb", "bg_blend_weights"):
        if k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(got["psv"].numpy(), np.asarray(want["psv"]),
                               rtol=0, atol=2e-3)
    # the JAX GCN's prediction, assembled on the port's PSV
    verts_in = []
    for img, order in (("ref_image", -1), ("src_image", 1)):
        verts_in.append(jsweep.gcn_sphere_sweep(
            jmsi.preprocess_image(jbatch[img]), order, jnp.asarray(depths),
            coords, jbatch["ref_pose"], jbatch["intrinsics"]))
    pred = jgcn.mesh_to_equirect(model.apply(
        params, jnp.concatenate(verts_in, axis=-1)[0]), p2v)
    rgba = jmsi.assemble_rgba(scheme, pred, jnp.asarray(got["psv"].numpy()),
                              P)["rgba_layers"]
    np.testing.assert_allclose(got["rgba_layers"].numpy(), np.asarray(rgba),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

TRAIN_CONFIGS = {"tgt": {}, "src_ref_wreg": dict(
    supervision="tgt_src_ref", wreg=True, spherical_attention=True)}


@pytest.mark.parametrize("name", list(TRAIN_CONFIGS))
def test_gcn_loss_and_grads_match_jax(tmp_path, name):
    """Loss within 1e-5 relative (1e-4 with spherical attention, whose
    latitude map JAX forms in float32 and the port in float64,
    tests/test_torch_train.py), every gradient leaf within relative L2
    1e-4 of the JAX one."""
    kw = TRAIN_CONFIGS[name]
    rtol = 1e-4 if kw.get("spherical_attention") else 1e-5
    jcfg, tcfg = _cfgs(tmp_path, **kw)
    params, model, coords, p2v = _jax_gcn(jcfg)
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jstep.make_loss_fn(jcfg, model.apply, gcn_inputs=(coords, p2v))
    (jloss, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jbatch, jax.random.PRNGKey(1))
    depths = jnp.asarray(jsweep.inv_depths(jcfg.min_depth, jcfg.max_depth,
                                           P))
    psv = np.asarray(jsweep.format_network_input(
        jmsi.preprocess_image(jbatch["ref_image"]),
        jmsi.preprocess_image(jbatch["src_image"]), jbatch["ref_pose"],
        jbatch["src_pose"], jbatch["ref_pose_inv"], depths,
        jbatch["intrinsics"]))
    vol = torch.from_numpy(psv.copy()).permute(0, 3, 1, 2).contiguous()
    net, tcoords, tp2v = _torch_gcn(tcfg, params)
    loss, aux = tstep.make_loss_fn(
        tcfg, net, sweep=lambda cfg, b, d: vol,
        gcn_inputs=(tcoords, tp2v))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    for k in ("reconstruction_loss", "weight_reg_loss"):
        assert (k in aux) == (k in jaux), k
        if k in aux:
            np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                       rtol=rtol, err_msg=k)
    want = weights.gcn_from_flax(jax.tree.map(np.asarray, jgrads))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for pname, w in want.items():
        g = got[pname].grad
        rel = float((g - w).norm() / max(float(w.norm()), 1e-30))
        assert rel <= 1e-4, (pname, rel)


def test_gcn_train_cli_runs_and_serves(tmp_path):
    """cli.train --gcn true for 4 steps on the synthetic fixture: finite
    losses, a checkpoint of the GCN's flax tree, which the test CLI
    serves."""
    from matryodshka_tpu_torch.data import synthetic
    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=H, width=W)
    flags = ["--device", "cpu", "--image_dir", str(tmp_path / "fix" /
                                                   "images"),
             "--cameras_glob", glob_pat, "--height", str(H), "--width",
             str(W), "--num_psv_planes", str(P), "--num_msi_planes", str(P),
             "--ngf", str(NGF), "--gcn", "true", "--subdiv", str(SUBDIV),
             "--mesh_dir", str(tmp_path / "mesh"), "--compute_dtype",
             "float32", "--checkpoint_dir", str(tmp_path / "ckpt"),
             "--experiment_name", "g"]
    tcli_train.main(flags + ["--max_steps", "4", "--summary_freq", "1",
                             "--learning_rate", "1e-3"])
    import json
    recs = [json.loads(x) for x in (tmp_path / "ckpt" / "g" / "logs" /
                                    "metrics.jsonl").read_text()
            .splitlines()]
    losses = [r["total_loss"] for r in recs]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    tree, step = tcli.restore_params(str(tmp_path / "ckpt" / "g" / "4" /
                                         "params.npz"))
    assert step == 4 and set(tree["params"]["conv1_1"]) == {
        "weights_0", "weights_1", "bias"}
    tcli.main([f for f in flags if f not in ("--device", "cpu")][:] +
              ["--device", "cpu", "--output_root", str(tmp_path / "out"),
               "--test_outputs", "tgt_image", "--num_runs", "1"])
    outs = os.listdir(tmp_path / "out" / "g")
    assert "step.txt" in outs and len(outs) == 2


# ---------------------------------------------------------------------------
# The test CLI.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", COLOR_PREDS)
def test_gcn_infer_fn_matches_jax(tmp_path, scheme):
    """The port's kernel route (plain versions here) against the JAX CLI's
    GCN route (infer_gcn_msi and the gather renders): 2e-3 on the view and
    depth (the two sweeps' f32 projection noise at 20 m through the GCN,
    tests/test_torch_cli.py's bound), 1e-5 on the layers' weights."""
    jcfg, tcfg = _cfgs(tmp_path, which_color_pred=scheme, **DEPTHS)
    params, model, _, _ = _jax_gcn(jcfg)
    tparams = entry.make_params(tcfg, flax_params=jax.tree.map(
        np.asarray, params), device="cpu")
    batch = _batch(2)
    outputs = "tgt_image_blend_weights_alphas_rgba_layers"
    got = tcli.build_infer_fn(tcfg, tparams, outputs)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jcli.build_infer_fn(jcfg, model, outputs, allow_fused=False)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        tol = 2e-3 if k in ("output_image", "output_depth",
                            "rgba_layers") else TOL
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)
    plain = tcli.infer_plain(tcfg, tparams, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    for k in ("output_image", "output_depth"):
        np.testing.assert_allclose(plain[k].numpy(), got[k].numpy(), rtol=0,
                                   atol=TOL, err_msg=k)


def test_gcn_main_matches_jax_main(tmp_path):
    """Both CLIs with --gcn true over one fixture example: the same files,
    the .npy weights within 2e-3 and every PNG within 2 of 255 levels
    (tests/test_torch_cli.py's bounds)."""
    from matryodshka_tpu.data import synthetic
    from matryodshka_tpu.training.checkpoint import CheckpointManager
    from PIL import Image

    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=H, width=W)
    jcfg, _ = _cfgs(tmp_path / "mesh", **DEPTHS)
    state, _ = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    CheckpointManager(str(tmp_path / "ckpt" / "t")).save(state)
    flat = {f"params/{layer}/{leaf}": np.asarray(v)
            for layer, leaves in state.params["params"].items()
            for leaf, v in leaves.items()}
    flat["step"] = np.asarray(0)
    np.savez(tmp_path / "params.npz", **flat)
    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", str(H), "--width",
             str(W), "--num_psv_planes", str(P), "--num_msi_planes", str(P),
             "--ngf", str(NGF), "--compute_dtype", "float32",
             "--min_depth", "2", "--max_depth", "20", "--gcn", "true",
             "--subdiv", str(SUBDIV), "--mesh_dir", str(tmp_path / "mesh"),
             "--experiment_name", "t", "--num_runs", "1"]
    jcli.main(flags + ["--output_root", str(tmp_path / "jax"),
                       "--checkpoint_dir", str(tmp_path / "ckpt")])
    tcli.main(flags + ["--output_root", str(tmp_path / "torch"),
                       "--params", str(tmp_path / "params.npz"),
                       "--device", "cpu"])
    jroot, troot = tmp_path / "jax" / "t", tmp_path / "torch" / "t"

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(jroot)
    assert names == files(troot) and any(n.endswith(".npy") for n in names)
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(troot / name),
                                       np.load(jroot / name), rtol=0,
                                       atol=2e-3, err_msg=name)
        elif name.endswith(".png"):
            a = np.asarray(Image.open(troot / name), np.int32)
            b = np.asarray(Image.open(jroot / name), np.int32)
            diff = np.abs(a - b)
            assert diff.max() <= 2 and diff.mean() < 0.1, (name, diff.max())
        else:
            assert (troot / name).read_text() == (jroot / name).read_text()
