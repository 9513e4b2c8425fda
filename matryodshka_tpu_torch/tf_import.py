"""Import a reference (TF-v1) MatryODShka checkpoint into the port.

    python -m matryodshka_tpu_torch.tf_import SRC OUT.npz [--step N]
    python -m matryodshka_tpu_torch.cli.test --coord_net true \
        --params OUT.npz ...

SRC is a TF-v1 checkpoint prefix (`<SRC>.index` + `<SRC>.data-*`, read by
`tensor_bundle.load` without TensorFlow) or an `.npz` dump of its
variables (names with `/` or `|` separators). OUT.npz holds the flax
parameter tree under the keys `params/<layer>/<leaf>` plus `step`: the file
`cli/test.py --params` reads (`training/checkpoint.restore_params`). The
released checkpoints are the coord net; the tool prints which variant the
weights' shapes give, so that the CLI gets the matching `--coord_net`.

The port's own copy of `convert` and `load_tf_vars` of
`tools/import_tf_checkpoint.py`:

  * name mapping: net/convX_Y/{weights,biases} -> convX_Y {kernel, bias};
  * slim.layer_norm's net/convX_Y/LayerNorm/{beta,gamma} -> convX_Y_ln;
  * the conv2d_transpose kernel convention: TF's conv2d_transpose is the
    gradient of a conv, kernel [kh, kw, out, in], implicitly flipped;
    flax's ConvTranspose is a true transposed convolution with kernel
    [kh, kw, in, out]: a spatial flip and an axis swap.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from matryodshka_tpu_torch import tensor_bundle
from matryodshka_tpu_torch.training.checkpoint import save_params

CONV_LAYERS = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
               "conv3_2", "conv3_3", "conv4_1", "conv4_2", "conv4_3",
               "conv6_2", "conv6_3", "conv7_2", "conv8_2", "color_pred"]
DECONV_LAYERS = ["conv6_1", "conv7_1", "conv8_1"]


def convert(tf_vars: Dict) -> Dict:
    """TF var dict (slash-or-pipe-separated names) -> flax param tree
    {"params": {layer: {leaf: array}}}."""
    def get(name):
        for key in (name, name.replace("/", "|")):
            if key in tf_vars:
                return np.asarray(tf_vars[key])
        raise KeyError(f"missing variable {name}; have e.g. "
                       f"{list(tf_vars)[:5]}")

    params: Dict = {}
    for layer in CONV_LAYERS:
        entry = {"kernel": get(f"net/{layer}/weights")}
        try:
            entry["bias"] = get(f"net/{layer}/biases")
        except KeyError:
            pass
        params[layer] = entry
        if layer != "color_pred":
            params[layer + "_ln"] = {
                "beta": get(f"net/{layer}/LayerNorm/beta"),
                "gamma": get(f"net/{layer}/LayerNorm/gamma"),
            }
    for layer in DECONV_LAYERS:
        k = get(f"net/{layer}/weights")          # [kh, kw, out, in]
        # TF conv2d_transpose(k) == flax ConvTranspose(flip(k).swap):
        k = k[::-1, ::-1, :, :]                  # spatial flip
        k = np.transpose(k, (0, 1, 3, 2))        # [kh, kw, in, out]
        entry = {"kernel": k}
        try:
            entry["bias"] = get(f"net/{layer}/biases")
        except KeyError:
            pass
        params[layer] = entry
        params[layer + "_ln"] = {
            "beta": get(f"net/{layer}/LayerNorm/beta"),
            "gamma": get(f"net/{layer}/LayerNorm/gamma"),
        }
    return {"params": params}


def load_tf_vars(path: str) -> Dict[str, np.ndarray]:
    """TF variables from an .npz dump or from a TF-v1 checkpoint prefix."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as blob:
            return {k: blob[k] for k in blob.files}
    return tensor_bundle.load(path)


def variant_of(params: Dict) -> str:
    """"coord" when conv1_2 reads one channel more than conv1_1 writes
    (the coord channel), else "wrap"."""
    p = params["params"]
    return ("coord" if p["conv1_2"]["kernel"].shape[2]
            == p["conv1_1"]["kernel"].shape[3] + 1 else "wrap")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="TF-v1 checkpoint prefix, or an .npz of "
                                "its variables")
    ap.add_argument("out", help=".npz to write (cli/test.py --params)")
    ap.add_argument("--step", type=int, default=0)
    args = ap.parse_args(argv)

    params = convert(load_tf_vars(args.src))
    n = sum(int(np.asarray(v).size) for layer in params["params"].values()
            for v in layer.values())
    save_params(args.out, params, args.step)
    variant = variant_of(params)
    print(f"converted {n:,} parameters across {len(params['params'])} "
          f"modules ({variant} net) to {args.out} @ step {args.step}; run "
          f"the test CLI with --coord_net {str(variant == 'coord').lower()}")


if __name__ == "__main__":
    main()
