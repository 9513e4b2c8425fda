"""Host-side loading of Replica ODS examples as numpy batches.

The ODS part of `matryodshka_tpu/data/loader.py` (`OdsLoader`,
`make_loader`, `device_prefetch`): a thread pool decodes and resizes the
JPEGs (PIL releases the GIL) and batches are numpy dicts, which the caller
moves to its device, or `device_prefetch` moves ahead of the step that
needs them. The PP and RealEstate loaders are not ported yet (ROADMAP
Queue 1 item 5).

Batch dict contract (ODS; data_loader.py:124-185):
  ref_image/src_image/tgt_image: [B, H, W, 3] float32 in [0, 1]
  (+ hres_ref_image/hres_src_image/hres_tgt_image with load_hres)
  ref_pose/src_pose/ref_pose_inv: [B, 4, 4] identity
  tgt_pose:          [B, 3] target offset vector
  tgt_pose_rt:       [B, 4, 4] [I | tgt_pose]
  intrinsics:        [B, 3, 3] with [0, 0] = baseline
  scene_id, image_ids: lists (for the output names)
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
from matryodshka_tpu_torch.data.records import OdsSequence


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


def make_loader(cfg, training: bool = True, **kwargs):
    """Loader factory keyed on cfg.input_type (the reference's per-type
    data_loader dispatch, test.py:51 / train.py:104-115)."""
    if cfg.input_type != "ODS":
        raise NotImplementedError(
            f"input_type {cfg.input_type!r}: the PP and RealEstate loaders "
            f"are not ported (ROADMAP Queue 1 item 5)")
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
