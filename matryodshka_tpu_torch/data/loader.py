"""Host-side loading of Replica ODS, Replica perspective and RealEstate10K
examples as numpy batches.

Counterpart of `matryodshka_tpu/data/loader.py` (`OdsLoader`,
`ReplicaPerspectiveLoader`, `RealEstateLoader`, `make_loader`,
`device_prefetch`): a thread pool decodes and resizes the JPEGs (PIL
releases the GIL) and batches are numpy dicts, which the caller moves to
its device, or `device_prefetch` moves ahead of the step that needs them.
Each loader draws from np.random.RandomState(cfg.random_seed) in the JAX
loader's call order, so a seed gives both packages the same batches.

Batch dict contract (ODS; data_loader.py:124-185):
  ref_image/src_image/tgt_image: [B, H, W, 3] float32 in [0, 1]
  (+ hres_ref_image/hres_src_image/hres_tgt_image with load_hres)
  ref_pose/src_pose/ref_pose_inv: [B, 4, 4] identity
  tgt_pose:          [B, 3] target offset vector
  tgt_pose_rt:       [B, 4, 4] [I | tgt_pose]
  intrinsics:        [B, 3, 3] with [0, 0] = baseline
  scene_id, image_ids: lists (for the output names)
PP and REALESTATE_PP: the same images; ref_pose/src_pose/tgt_pose
[B, 4, 4] world-to-camera poses, intrinsics [B, 3, 3] pinhole K in
pixels, ref_pose_inv [B, 4, 4] the inverse of the sweep's reference frame
(PP: of interp_pose, the slerp midpoint of ref and src; RealEstate: of
ref_pose).
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from matryodshka_tpu_torch.data import images as img_lib
from matryodshka_tpu_torch.data import parsers
from matryodshka_tpu_torch.data.records import OdsSequence, \
    RealEstateSequence
from matryodshka_tpu_torch.geometry.cameras import interpolate_pose


class OdsLoader:
    """Replica ODS loader, in training order (shuffled, endless) or
    evaluation order (camera-file order, once). load_hres adds the
    hres_* images at (hres_height, hres_width), read from
    cfg.hres_image_dir under image_dir's file names, as the
    reference's separate hres_image does (its datasets.py OdsSequence; the
    JAX loader stores the field and reads image_dir instead)."""

    def __init__(self, cfg, cameras_glob: Optional[str] = None,
                 image_dir: Optional[str] = None, training: bool = True,
                 load_hres: bool = False, num_workers: int = 8):
        self.cfg = cfg
        self.training = training
        self.image_dir = image_dir or cfg.image_dir
        self.load_hres = load_hres
        self.num_workers = num_workers
        self.sequences = parsers.load_ods_sequences(
            cameras_glob or cfg.cameras_glob, cfg.shuffle_seq_length)
        if not self.sequences:
            raise FileNotFoundError(
                f"no camera lines matched {cameras_glob or cfg.cameras_glob}")
        self.rng = np.random.RandomState(cfg.random_seed)

    def __len__(self):
        return len(self.sequences)

    def _load_example(self, seq: OdsSequence, pool) -> Dict:
        cfg = self.cfg
        paths = [img_lib.ods_image_path(self.image_dir, seq.scene_id, iid)
                 for iid in seq.image_ids]
        imgs = list(pool.map(
            lambda p: img_lib.load_and_resize(p, cfg.height, cfg.width),
            paths))
        ex = {
            "ref_image": imgs[0], "src_image": imgs[1], "tgt_image": imgs[2],
            "tgt_pose": seq.tgt_pos.astype(np.float32),
            "baseline": np.float32(seq.baseline),
            "scene_id": seq.scene_id,
            "image_ids": list(seq.image_ids),
        }
        if self.load_hres:
            hres = list(pool.map(
                lambda iid: img_lib.load_and_resize(
                    img_lib.ods_image_path(cfg.hres_image_dir, seq.scene_id,
                                           iid),
                    cfg.hres_height, cfg.hres_width), seq.image_ids))
            ex["hres_ref_image"], ex["hres_src_image"], \
                ex["hres_tgt_image"] = hres
        return ex

    def _format_batch(self, examples: List[Dict]) -> Dict:
        b = len(examples)
        eye = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
        batch: Dict = {"ref_pose": eye, "src_pose": eye.copy(),
                       "ref_pose_inv": eye.copy()}
        for k in ("ref_image", "src_image", "tgt_image", "hres_ref_image",
                  "hres_src_image", "hres_tgt_image", "tgt_pose"):
            if k in examples[0]:
                batch[k] = np.stack([e[k] for e in examples])
        intr = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
        intr[:, 0, 0] = [e["baseline"] for e in examples]
        batch["intrinsics"] = intr
        rt = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
        rt[:, :3, 3] = batch["tgt_pose"]
        batch["tgt_pose_rt"] = rt
        batch["scene_id"] = [e["scene_id"] for e in examples]
        batch["image_ids"] = [e["image_ids"] for e in examples]
        return batch

    def _sequence_iter(self) -> Iterator[OdsSequence]:
        if self.training:
            while True:
                for i in self.rng.permutation(len(self.sequences)):
                    yield self.sequences[i]
        else:
            yield from self.sequences

    def batches(self) -> Iterator[Dict]:
        it = self._sequence_iter()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            while True:
                seqs = list(itertools.islice(it, self.cfg.batch_size))
                if len(seqs) < self.cfg.batch_size:
                    return
                yield self._format_batch([self._load_example(s, pool)
                                          for s in seqs])


class ReplicaPerspectiveLoader:
    """Replica perspective (PP) loader (data_loader.py:187-241), in
    training order (shuffled, endless) or evaluation order (once).

    Camera line: scene_id img1 img2 img3 input_offset tgt_offset. Poses:
    ref = I; src = [I | (-input_offset, 0, 0)]; tgt = [I | (-tgt_offset,
    0, 0)]. Intrinsics: fx = cx = W/2, fy = cy = H/2. The sweep's and the
    render's reference frame is the slerp midpoint of ref and src
    (train.py:119-120), `interp_pose`; its inverse is `ref_pose_inv`."""

    def __init__(self, cfg, cameras_glob: Optional[str] = None,
                 image_dir: Optional[str] = None, training: bool = True,
                 num_workers: int = 8):
        self.cfg = cfg
        self.training = training
        self.image_dir = image_dir or cfg.image_dir
        self.num_workers = num_workers
        self.sequences = parsers.load_perspective_sequences(
            cameras_glob or cfg.cameras_glob)
        if not self.sequences:
            raise FileNotFoundError(
                f"no camera lines matched {cameras_glob or cfg.cameras_glob}")
        self.rng = np.random.RandomState(cfg.random_seed)

    def _load_example(self, seq, pool) -> Dict:
        cfg = self.cfg
        paths = [img_lib.ods_image_path(self.image_dir, seq.scene_id, iid)
                 for iid in seq.image_ids]
        imgs = list(pool.map(
            lambda p: img_lib.load_and_resize(p, cfg.height, cfg.width),
            paths))
        return {"ref_image": imgs[0], "src_image": imgs[1],
                "tgt_image": imgs[2],
                "input_offset": np.float32(seq.input_offset),
                "tgt_offset": np.float32(seq.tgt_offset),
                "scene_id": seq.scene_id,
                "image_ids": list(seq.image_ids)}

    def _format_batch(self, examples) -> Dict:
        b = len(examples)
        h, w = self.cfg.height, self.cfg.width
        batch: Dict = {k: np.stack([e[k] for e in examples])
                       for k in ("ref_image", "src_image", "tgt_image")}
        ref = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
        src = ref.copy()
        tgt = ref.copy()
        src[:, 0, 3] = [-e["input_offset"] for e in examples]
        tgt[:, 0, 3] = [-e["tgt_offset"] for e in examples]
        batch["ref_pose"], batch["src_pose"], batch["tgt_pose"] = \
            ref, src, tgt
        K = np.zeros((b, 3, 3), np.float32)
        K[:, 0, 0] = 0.5 * w
        K[:, 1, 1] = 0.5 * h
        K[:, 0, 2] = 0.5 * w
        K[:, 1, 2] = 0.5 * h
        K[:, 2, 2] = 1.0
        batch["intrinsics"] = K
        interp = np.stack([
            interpolate_pose(torch.from_numpy(r), torch.from_numpy(s)).numpy()
            for r, s in zip(ref, src)])
        batch["interp_pose"] = interp
        batch["ref_pose_inv"] = np.linalg.inv(interp)
        batch["scene_id"] = [e["scene_id"] for e in examples]
        batch["image_ids"] = [e["image_ids"] for e in examples]
        return batch

    def _sequence_iter(self):
        if self.training:
            while True:
                for i in self.rng.permutation(len(self.sequences)):
                    yield self.sequences[i]
        else:
            yield from self.sequences

    def batches(self) -> Iterator[Dict]:
        it = self._sequence_iter()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            while True:
                seqs = list(itertools.islice(it, self.cfg.batch_size))
                if len(seqs) < self.cfg.batch_size:
                    return
                yield self._format_batch([self._load_example(s, pool)
                                          for s in seqs])


class RealEstateLoader:
    """RealEstate10K loader with the reference's augmentations
    (loader.py:47-183, data_loader.py:245-381). Training: a random
    subsequence of shuffle_seq_length frames at a stride drawn from
    [min_stride, max_stride], reversed with probability 1/2, scaled by
    1.0-1.15 per axis and cropped back to (height, width) at a random
    offset (the intrinsics follow), then a random tgt frame and a random
    distinct (ref, src) pair. Evaluation: the middle frames at stride 1,
    no augmentation. Training admits a clip of at least
    (n-1)*max_stride + 1 frames (reference loader.py:118), so the stride
    draw is never clamped; evaluation needs n frames."""

    def __init__(self, cfg, cameras_glob: Optional[str] = None,
                 image_dir: Optional[str] = None, training: bool = True,
                 shuffle_seq_length: int = 10, num_workers: int = 8,
                 min_stride: int = 3, max_stride: int = 10):
        self.cfg = cfg
        self.training = training
        self.image_dir = image_dir or cfg.image_dir
        self.shuffle_seq_length = shuffle_seq_length
        self.min_stride = min_stride
        self.max_stride = max_stride
        self.num_workers = num_workers
        self.sequences = parsers.load_realestate_sequences(
            cameras_glob or cfg.cameras_glob)
        if not self.sequences:
            raise FileNotFoundError(
                f"no camera files matched {cameras_glob or cfg.cameras_glob}")
        n = shuffle_seq_length
        required = (n - 1) * max_stride + 1 if training else n
        self.sequences = [s for s in self.sequences if len(s) >= required]
        if not self.sequences:
            raise ValueError(
                f"all sequences shorter than the admission rule "
                f"(need {required} frames for length {n} at max stride "
                f"{max_stride})")
        self.rng = np.random.RandomState(cfg.random_seed)

    def _load_images(self, seq: RealEstateSequence, height, width, pool):
        paths = [img_lib.realestate_image_path(self.image_dir, seq.seq_id, t)
                 for t in seq.timestamps]
        return np.stack(list(pool.map(
            lambda p: img_lib.load_and_resize(p, height, width), paths)))

    def _example(self, seq: RealEstateSequence, pool) -> Dict:
        cfg = self.cfg
        n = self.shuffle_seq_length
        if self.training:
            sub = seq.random_subsequence(self.rng, n,
                                         min_stride=self.min_stride,
                                         max_stride=self.max_stride)
            if self.rng.rand() < 0.5:
                sub = sub.reverse()
        else:
            start = max(0, (len(seq) - n) // 2)
            sub = seq.subsequence(start, start + n)

        # random scale and crop (datasets.py:280-312), the normalized
        # intrinsics adjusted to the crop
        h, w = cfg.height, cfg.width
        if self.training:
            sy, sx = self.rng.uniform(1.0, 1.15, size=2)
            sh, sw = int(round(h * sy)), int(round(w * sx))
            imgs = self._load_images(sub, sh, sw, pool)
            oy = self.rng.randint(0, sh - h + 1)
            ox = self.rng.randint(0, sw - w + 1)
            imgs = imgs[:, oy:oy + h, ox:ox + w]
            intr_px = sub.intrinsics * np.asarray([sw, sh, sw, sh],
                                                  np.float32)
            intr_px = intr_px - np.asarray([0, 0, ox, oy], np.float32)
            intr = intr_px / np.asarray([w, h, w, h], np.float32)
        else:
            imgs = self._load_images(sub, h, w, pool)
            intr = sub.intrinsics

        # random tgt and (ref, src) frames (data_loader.py:319-329)
        tgt_idx = self.rng.randint(0, n)
        perm = self.rng.permutation(n)
        ref_idx, src_idx = int(perm[0]), int(perm[1])

        def pose4(i):
            p = np.eye(4, dtype=np.float32)
            p[:3, :4] = sub.poses[i]
            return p

        fx, fy, cx, cy = intr[ref_idx]
        K = np.asarray([[fx * w, 0, cx * w], [0, fy * h, cy * h],
                        [0, 0, 1]], np.float32)
        return {
            "tgt_image": imgs[tgt_idx], "ref_image": imgs[ref_idx],
            "src_image": imgs[src_idx],
            "tgt_pose": pose4(tgt_idx), "ref_pose": pose4(ref_idx),
            "src_pose": pose4(src_idx), "intrinsics": K,
            "scene_id": sub.seq_id,
            "image_ids": [str(sub.timestamps[i])
                          for i in (ref_idx, src_idx, tgt_idx)],
        }

    def batches(self) -> Iterator[Dict]:
        order = itertools.cycle(range(len(self.sequences))) \
            if self.training else iter(range(len(self.sequences)))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            while True:
                idx = list(itertools.islice(order, self.cfg.batch_size))
                if len(idx) < self.cfg.batch_size:
                    return
                exs = [self._example(self.sequences[i], pool) for i in idx]
                batch = {k: np.stack([e[k] for e in exs])
                         for k in ("tgt_image", "ref_image", "src_image",
                                   "tgt_pose", "ref_pose", "src_pose",
                                   "intrinsics")}
                batch["ref_pose_inv"] = np.linalg.inv(batch["ref_pose"])
                batch["scene_id"] = [e["scene_id"] for e in exs]
                batch["image_ids"] = [e["image_ids"] for e in exs]
                yield batch


def make_loader(cfg, training: bool = True, **kwargs):
    """Loader factory keyed on cfg.input_type (the reference's per-type
    data_loader dispatch, test.py:51 / train.py:104-115). RealEstate clips
    use length-10 windows (reference loader.py:361), whatever
    shuffle_seq_length says for the ODS groups. The ODS loader reads the
    high-res images when cfg supervises hrestgt (JAX data/loader.py:51)."""
    if cfg.input_type == "REALESTATE_PP":
        kwargs.setdefault("shuffle_seq_length", 10)
        return RealEstateLoader(cfg, training=training, **kwargs)
    if cfg.input_type == "PP":
        return ReplicaPerspectiveLoader(cfg, training=training, **kwargs)
    kwargs.setdefault("load_hres", cfg.supervise_hrestgt)
    return OdsLoader(cfg, training=training, **kwargs)


def device_prefetch(batch_iter: Iterator[Dict], size: int = 2,
                    device="cuda") -> Iterator[Dict]:
    """Move batches to `device` ahead of their use (the tf.data prefetch
    of the reference): a thread copies the next `size` batches while the
    current step computes. On a CUDA device each numpy array is copied
    into pinned host memory and sent with a non_blocking copy on a side
    stream, so the copy overlaps the step's kernels; the consumer's stream
    waits for the copy's event before the batch is handed over. On the CPU
    the arrays are wrapped as tensors. Entries that are not numpy arrays
    pass through. A loader error is raised in the consumer; closing the
    iterator stops the thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = threading.Event()
    end = object()

    def to_device(batch):
        out = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in batch.items()}
        if not cuda:
            return out, None
        with torch.cuda.stream(side):
            for k, v in out.items():
                if torch.is_tensor(v):
                    out[k] = v.pin_memory().to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return out, copied

    def hand_over(batch, copied):
        """Make the consumer's stream wait for the copies, and tell the
        allocator it uses the tensors the side stream allocated."""
        if copied is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(copied)
            for v in batch.values():
                if torch.is_tensor(v):
                    v.record_stream(stream)
        return batch

    def offer(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for batch in batch_iter:
                if not offer(to_device(batch)):
                    return
            offer(end)
        except Exception as err:  # handed to the consumer, raised there
            offer(err)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield hand_over(*item)
    finally:
        done.set()
        thread.join(timeout=60)
