"""Synthetic fixture datasets: procedural scenes + camera files.

Copy of `matryodshka_tpu/data/synthetic.py` (the files it writes are the
JAX package's byte for byte at equal arguments): real on-disk datasets in
the layouts the reference consumes, without shipping any data. Replica
ODS ({scene}_pos{id}.jpeg + glob txts; a textured sphere with parallax
faked by longitude shifts), Replica perspective (PP: the same naming,
camera lines with the input and target offsets) and RealEstate10K (one
directory of frames per clip, a camera file per clip with a pose per
frame). `erp_texture` needs numpy only; writing a fixture needs PIL, which
`write_image` imports when it runs.

Usage: python -m matryodshka_tpu_torch.data.synthetic OUTDIR [--height H]
           [--realestate [--frames N]]
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


def make_perspective_fixture(out_dir: str, num_scenes: int = 2,
                             height: int = 64, width: int = 64,
                             seed: int = 0) -> str:
    """Replica perspective (PP) layout: same image naming as ODS, camera
    lines 'scene img1 img2 img3 input_offset tgt_offset'."""
    img_dir = os.path.join(out_dir, "images")
    cam_dir = os.path.join(out_dir, "cams")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    for s in range(num_scenes):
        scene = f"ppscene{s:02d}"
        tex = erp_texture(height, width, seed=seed + 50 + s)
        for k, iid in enumerate(["a", "b", "c"]):
            img = np.roll(tex, k * 2, axis=1)
            write_image(os.path.join(img_dir, f"{scene}_pos{iid}.jpeg"),
                        img)
        with open(os.path.join(cam_dir, f"{scene}.txt"), "w") as fh:
            fh.write(f"{scene} a b c 0.1 0.05\n")
    return os.path.join(cam_dir, "*.txt")


def make_realestate_fixture(out_dir: str, num_seqs: int = 1,
                            frames: int = 12, height: int = 64,
                            width: int = 128, seed: int = 0) -> str:
    """Write a tiny RealEstate10K-layout dataset; returns the glob. Frame f
    of clip s is the clip's texture rolled by 2f columns, with the pose
    [I | (-0.02 f, 0, 0)] and normalized intrinsics (0.9, 1.2, 0.5, 0.5).
    The training loader admits a clip of at least (n-1)*max_stride + 1
    frames (91 for its length 10 at stride up to 10). seed is accepted as
    the JAX function accepts it: the textures are seeded by clip."""
    img_dir = os.path.join(out_dir, "images")
    cam_dir = os.path.join(out_dir, "cams")
    os.makedirs(cam_dir, exist_ok=True)
    for s in range(num_seqs):
        seq_id = f"vid{s:04d}"
        os.makedirs(os.path.join(img_dir, seq_id), exist_ok=True)
        tex = erp_texture(height, width, seed=100 + s)
        lines = [f"https://www.youtube.com/watch?v={seq_id}"]
        for f in range(frames):
            ts = str(1000 + f * 100)
            img = np.roll(tex, f * 2, axis=1)
            write_image(os.path.join(img_dir, seq_id,
                                     f"{seq_id}_{ts}.jpg"), img)
            pose = np.eye(4)[:3]
            pose[0, 3] = -0.02 * f
            vals = ([ts, "0.9", "1.2", "0.5", "0.5", "0", "0"]
                    + [f"{x:.6f}" for x in pose.reshape(-1)])
            lines.append(" ".join(vals))
        with open(os.path.join(cam_dir, f"{seq_id}.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return os.path.join(cam_dir, "*.txt")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--num_scenes", type=int, default=2)
    ap.add_argument("--realestate", action="store_true")
    ap.add_argument("--frames", type=int, default=12,
                    help="frames of the RealEstate clip (91 for training)")
    args = ap.parse_args()
    if args.realestate:
        g = make_realestate_fixture(args.out_dir, frames=args.frames,
                                    height=args.height, width=args.width)
    else:
        g = make_ods_fixture(args.out_dir, num_scenes=args.num_scenes,
                             height=args.height, width=args.width)
    print(f"fixture written; cameras glob: {g}")


if __name__ == "__main__":
    main()
