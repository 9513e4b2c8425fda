"""Synthetic fixture dataset: procedural ERP scenes + camera files.

Copy of the ODS part of `matryodshka_tpu/data/synthetic.py`: a real
on-disk dataset in the layout the reference consumes (Replica ODS:
{scene}_pos{id}.jpeg + glob txts), without shipping any data. The scene is
a textured sphere with parallax faked by longitude shifts. `erp_texture`
needs numpy only; writing the fixture needs PIL, which `write_image`
imports when it runs. (The PP and RealEstate fixtures come with their
loaders, ROADMAP Queue 1 item 5.)

Usage: python -m matryodshka_tpu_torch.data.synthetic OUTDIR [--height H]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from matryodshka_tpu_torch.data.images import write_image


def erp_texture(height: int, width: int, seed: int = 0) -> np.ndarray:
    """A colorful band-limited ERP texture in [0, 1], [H, W, 3]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    u = xx / width * 2 * np.pi
    v = yy / height * np.pi
    img = np.zeros((height, width, 3), np.float32)
    for c in range(3):
        acc = np.zeros_like(u)
        for k in range(1, 5):
            acc += (rng.rand() * np.sin(k * u + rng.rand() * 6)
                    * np.cos((k % 3 + 1) * v + rng.rand() * 6))
        img[..., c] = acc
    img -= img.min()
    img /= img.max() + 1e-6
    return img


def make_ods_fixture(out_dir: str, num_scenes: int = 2, height: int = 64,
                     width: int = 128, baseline: float = 0.032,
                     seed: int = 0) -> str:
    """Write a tiny Replica-ODS-layout dataset; returns the cameras glob."""
    img_dir = os.path.join(out_dir, "images")
    cam_dir = os.path.join(out_dir, "cams")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for s in range(num_scenes):
        scene = f"scene{s:02d}"
        tex = erp_texture(height, width, seed=seed + s)
        lines = []
        for group in range(2):
            ids = [f"{group}{k}" for k in range(3)]
            # fake parallax: ref/src/tgt are longitude-rolled copies
            for k, iid in enumerate(ids):
                shift = int(round((k - 1) * width * 0.01 * (group + 1)))
                img = np.roll(tex, shift, axis=1)
                write_image(os.path.join(
                    img_dir, f"{scene}_pos{iid}.jpeg"), img)
            off = rng.uniform(-0.05, 0.05, 3)
            lines.append(f"{scene} {ids[0]} {ids[1]} {ids[2]} "
                         f"{baseline} {off[0]:.4f} {off[1]:.4f} "
                         f"{off[2]:.4f}")
        with open(os.path.join(cam_dir, f"{scene}.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return os.path.join(cam_dir, "*.txt")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--num_scenes", type=int, default=2)
    args = ap.parse_args()
    g = make_ods_fixture(args.out_dir, num_scenes=args.num_scenes,
                         height=args.height, width=args.width)
    print(f"fixture written; cameras glob: {g}")


if __name__ == "__main__":
    main()
