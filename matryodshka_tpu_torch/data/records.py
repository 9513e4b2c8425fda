"""Sequence records for the three dataset families.

Numpy-side equivalents of the reference's tf.data namedtuples
(matryodshka/datasets.py:28-318), minus graph plumbing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class OdsSequence:
    """One Replica ODS training example (datasets.py:28-80).

    Camera line format (parse_replica_ods_camera_lines, datasets.py:413-425):
      scene_id img_id_ref img_id_src img_id_tgt baseline tx ty tz
    Images live at {image_dir}/{scene_id}_pos{image_id}.jpeg.
    """
    scene_id: str
    image_ids: List[str]          # [seq_length] (ref, src, tgt)
    baseline: float
    tgt_pos: np.ndarray           # [3]


@dataclass
class ReplicaPerspectiveSequence:
    """Replica perspective example (datasets.py:82-137, :427-437).

    Camera line: scene_id img1 img2 img3 input_offset tgt_offset.
    """
    scene_id: str
    image_ids: List[str]
    input_offset: float
    tgt_offset: float


@dataclass
class RealEstateSequence:
    """RealEstate10K sequence (datasets.py:139-318, :339-371).

    Camera file: line 0 = video URL (id after '='); each further line:
      timestamp fx fy cx cy k1 k2 p00..p23 (3x4 row-major pose).
    Intrinsics are normalized by image size. Images at
    {image_dir}/{id}/{id}_{timestamp}.jpg.
    """
    seq_id: str
    timestamps: List[str]
    intrinsics: np.ndarray        # [N, 4] (fx fy cx cy), normalized
    poses: np.ndarray             # [N, 3, 4] world-to-camera

    def __len__(self) -> int:
        return len(self.timestamps)

    def subsequence(self, start: int, end: int, stride: int = 1
                    ) -> "RealEstateSequence":
        sl = slice(start, end, stride)
        return RealEstateSequence(self.seq_id, self.timestamps[sl],
                                  self.intrinsics[sl], self.poses[sl])

    def reverse(self) -> "RealEstateSequence":
        return RealEstateSequence(self.seq_id, self.timestamps[::-1],
                                  self.intrinsics[::-1].copy(),
                                  self.poses[::-1].copy())

    def random_subsequence(self, rng: np.random.RandomState, length: int,
                           min_stride: int = 1, max_stride: int = 1
                           ) -> "RealEstateSequence":
        """Uniform random stride in [min, max] then uniform start
        (datasets.py:237-267). The training loader only admits sequences
        with >= (length-1)*max_stride + 1 frames (reference
        loader.py:118), so the clamp below never fires there; it is a
        guard for direct callers with short clips (the reference asserts
        instead)."""
        if length > len(self):
            raise ValueError(
                f"sequence {self.seq_id} shorter than requested length")
        feasible = (len(self) - 1) // max(1, length - 1)
        max_stride = max(min(max_stride, feasible), 1)
        min_stride = min(min_stride, max_stride)
        stride = (min_stride if max_stride == min_stride
                  else rng.randint(min_stride, max_stride + 1))
        maxval = len(self) - (length - 1) * stride
        index = rng.randint(0, max(1, maxval))
        return self.subsequence(index, index + 1 + (length - 1) * stride,
                                stride)
