"""Evaluation entry point (the reference's eval.py).

    python -m matryodshka_tpu_torch.cli.evaluate --result_root DIR \
        [--eval_type reg|video] [--remove_pole] [--with_elpips \
        [--elpips_weight_path W.npz | --allow_uncalibrated]] \
        [--output_json OUT.json] [--device cuda]

Counterpart of `matryodshka_tpu/cli/evaluate.py`, with its flags and its
JSON keys. Scans the test CLI's output directories, computes SSIM and
PSNR (and E-LPIPS with --with_elpips) of each rendered target view
against its ground truth, and writes their averages and variances
(eval.py:127-145, 262-300); video mode computes the frame-to-frame
blurred RGB and depth diffs of consecutive video_* directories
(eval.py:147-260). `--remove_pole` crops the top and bottom quarters.
E-LPIPS draws its ensemble from a generator seeded 0 for every example,
as the JAX package draws from PRNGKey(0).

The metrics run on `--device`, `cuda` by default; without a card that
raises rather than running on the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

import numpy as np
import torch

from matryodshka_tpu_torch.evaluation import metrics as M


def _load(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def collect_examples(result_dir: str) -> List[Dict[str, str]]:
    """(gt, output) image pairs of the test output dirs (eval.py:62-95
    layout: {dir}/tgt_image_{name}.png + {dir}/output_tgt_{name}.png)."""
    examples = []
    for d in sorted(glob.glob(os.path.join(result_dir, "*"))):
        if not os.path.isdir(d):
            continue
        name = os.path.basename(d)
        gt = os.path.join(d, f"tgt_image_{name}.png")
        out = os.path.join(d, f"output_tgt_{name}.png")
        if os.path.exists(gt) and os.path.exists(out):
            examples.append({"name": name, "gt": gt, "out": out})
    return examples


def collect_video_examples(result_dir: str) -> List[Dict[str, str]]:
    """Consecutive-frame pairs from video_* dirs (eval.py:97-125)."""
    dirs = sorted(d for d in glob.glob(os.path.join(result_dir, "video_*"))
                  if os.path.isdir(d))
    pairs = []
    for a, b in zip(dirs, dirs[1:]):
        na, nb = os.path.basename(a), os.path.basename(b)
        pairs.append({
            "rgb_a": os.path.join(a, f"output_tgt_{na}.png"),
            "rgb_b": os.path.join(b, f"output_tgt_{nb}.png"),
            "depth_a": os.path.join(a, f"output_depth_{na}.png"),
            "depth_b": os.path.join(b, f"output_depth_{nb}.png"),
        })
    return pairs


def evaluate_one(gt: np.ndarray, out: np.ndarray, remove_pole: bool = False,
                 elpips_metric=None, device="cuda") -> Dict[str, float]:
    """SSIM, PSNR (and E-LPIPS, the metric on `device`) of one [H, W, 3]
    output against its ground truth, on device (the card unless the
    caller asks for the CPU)."""
    if remove_pole:
        gt, out = M.remove_pole(gt), M.remove_pole(out)
    gt_t = torch.from_numpy(np.ascontiguousarray(gt)).to(device)
    out_t = torch.from_numpy(np.ascontiguousarray(out)).to(device)
    scores = {"ssim": float(M.ssim(out_t, gt_t)),
              "psnr": float(M.psnr(out_t, gt_t))}
    if elpips_metric is not None:
        with torch.no_grad():
            d = elpips_metric(out_t[None], gt_t[None],
                              generator=torch.Generator().manual_seed(0))
        scores["elpips"] = float(d.mean())
    return scores


def aggregate(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out = {}
    if not rows:
        return out
    for k in rows[0]:
        vals = np.asarray([r[k] for r in rows], np.float64)
        out[f"avg_{k}"] = float(vals.mean())
        out[f"var_{k}"] = float(vals.var())
    return out


def build_parser() -> argparse.ArgumentParser:
    """The JAX evaluator's flags, plus --device."""
    ap = argparse.ArgumentParser(description="matryodshka eval (torch)")
    ap.add_argument("--result_root", type=str, required=True,
                    help="test output dir ({output_root}/{experiment})")
    ap.add_argument("--eval_type", type=str, default="reg",
                    choices=["reg", "video"])
    ap.add_argument("--remove_pole", action="store_true")
    ap.add_argument("--with_elpips", action="store_true")
    ap.add_argument("--elpips_weight_path", type=str, default=None)
    ap.add_argument("--allow_uncalibrated", action="store_true",
                    help="permit E-LPIPS scores computed with random "
                         "conv features (no --elpips_weight_path); the "
                         "numbers are NOT the calibrated perceptual "
                         "distance and are stamped as such in the JSON")
    ap.add_argument("--output_json", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> Dict:
    """Writes the JSON table (by default <result_root>/eval_<type>.json)
    and returns it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass "
                           "--device cpu to evaluate on the CPU)")

    elpips_metric = None
    if args.with_elpips:
        from matryodshka_tpu_torch.losses.elpips import api as elpips_api
        elpips_metric = elpips_api.Metric(
            elpips_api.elpips_vgg(batch_size=1),
            weight_path=args.elpips_weight_path).to(device)
        if not elpips_metric.calibrated and not args.allow_uncalibrated:
            # The reference always evaluates with real pretrained
            # features (eval.py:138-142); a random-feature score must
            # never leave this tool looking like one.
            ap.error(
                "E-LPIPS would run with RANDOM conv features (no "
                "--elpips_weight_path). Scores would be meaningless as "
                "perceptual distances. Pass --elpips_weight_path or opt in "
                "explicitly with --allow_uncalibrated.")

    result: Dict = {"result_root": args.result_root,
                    "eval_type": args.eval_type}
    if elpips_metric is not None:
        result["elpips_calibrated"] = bool(elpips_metric.calibrated)
    if args.eval_type == "reg":
        examples = collect_examples(args.result_root)
        print(f"[eval] {len(examples)} examples")
        rows = []
        for ex in examples:
            scores = evaluate_one(_load(ex["gt"]), _load(ex["out"]),
                                  args.remove_pole, elpips_metric, device)
            print(f"  {ex['name']}: " + " ".join(
                f"{k}={v:.4f}" for k, v in scores.items()))
            rows.append({**scores, "name": ex["name"]})
        result["per_example"] = rows
        result.update(aggregate(
            [{k: v for k, v in r.items() if isinstance(v, float)}
             for r in rows]))
    else:
        pairs = collect_video_examples(args.result_root)
        print(f"[eval] {len(pairs)} consecutive-frame pairs")

        def diff(a, b):
            return float(M.temporal_diff(
                torch.from_numpy(_load(a)).to(device),
                torch.from_numpy(_load(b)).to(device)))

        rgb_diffs = [diff(p["rgb_a"], p["rgb_b"]) for p in pairs]
        depth_diffs = [diff(p["depth_a"], p["depth_b"]) for p in pairs
                       if os.path.exists(p["depth_a"])]
        result["avg_rgb_diff"] = float(np.mean(rgb_diffs)) if rgb_diffs \
            else None
        result["sd_rgb_diff"] = float(np.std(rgb_diffs)) if rgb_diffs \
            else None
        if depth_diffs:
            result["avg_depth_diff"] = float(np.mean(depth_diffs))
            result["sd_depth_diff"] = float(np.std(depth_diffs))

    out_path = args.output_json or os.path.join(
        args.result_root, f"eval_{args.eval_type}.json")
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=2)
    print(f"[eval] wrote {out_path}")
    print(json.dumps({k: v for k, v in result.items()
                      if isinstance(v, float)}, indent=2))
    return result


if __name__ == "__main__":
    main()
