"""Camera-file parsers for the three dataset families.

Formats reproduced exactly from matryodshka/datasets.py:320-437.
Lines starting with '#' are skipped (read_file_lines, datasets.py:333-337).
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from matryodshka_tpu_torch.data.records import (OdsSequence,
                                                RealEstateSequence,
                                                ReplicaPerspectiveSequence)


def read_file_lines(path: str, max_lines: int = 10000) -> List[str]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(line)
            if len(out) >= max_lines:
                break
    return out


def parse_replica_ods_camera_line(line: str, seq_length: int = 3
                                  ) -> OdsSequence:
    """scene_id img_id*seq_length baseline tx ty tz
    (datasets.py:413-425)."""
    parts = line.split(" ")
    scene_id = parts[0]
    image_ids = parts[1:1 + seq_length]
    baseline = float(parts[1 + seq_length])
    tgt_pos = np.asarray([float(x) for x in
                          parts[2 + seq_length:5 + seq_length]],
                         dtype=np.float32)
    return OdsSequence(scene_id, image_ids, baseline, tgt_pos)


def parse_replica_perspective_camera_line(line: str
                                          ) -> ReplicaPerspectiveSequence:
    """scene_id img1 img2 img3 input_offset tgt_offset
    (datasets.py:427-437)."""
    parts = line.split(" ")
    return ReplicaPerspectiveSequence(parts[0], parts[1:4],
                                      float(parts[4]), float(parts[5]))


def parse_realestate_camera_file(lines: List[str]) -> RealEstateSequence:
    """First line = video URL; id is the part after '='.
    Each further line: timestamp fx fy cx cy k1 k2 + 12 pose entries
    (datasets.py:339-371). Nonzero k1/k2 are rejected like the reference's
    assert."""
    url = lines[0]
    seq_id = url.split("=")[-1]
    timestamps, intr, poses = [], [], []
    for line in lines[1:]:
        vals = line.split(" ")
        timestamps.append(vals[0])
        nums = [float(x) for x in vals[1:]]
        if abs(nums[4]) > 0 or abs(nums[5]) > 0:
            raise ValueError(f"nonzero radial distortion in {seq_id}")
        intr.append(nums[0:4])
        poses.append(np.asarray(nums[6:18], dtype=np.float32
                                ).reshape(3, 4))
    return RealEstateSequence(seq_id, timestamps,
                              np.asarray(intr, dtype=np.float32),
                              np.stack(poses))


def load_ods_sequences(cameras_glob: str, seq_length: int = 3
                       ) -> List[OdsSequence]:
    seqs = []
    for path in sorted(glob.glob(cameras_glob)):
        for line in read_file_lines(path):
            seqs.append(parse_replica_ods_camera_line(line, seq_length))
    return seqs


def load_perspective_sequences(cameras_glob: str
                               ) -> List[ReplicaPerspectiveSequence]:
    seqs = []
    for path in sorted(glob.glob(cameras_glob)):
        for line in read_file_lines(path):
            seqs.append(parse_replica_perspective_camera_line(line))
    return seqs


def load_realestate_sequences(cameras_glob: str) -> List[RealEstateSequence]:
    seqs = []
    for path in sorted(glob.glob(cameras_glob)):
        lines = read_file_lines(path)
        if len(lines) >= 2:
            seqs.append(parse_realestate_camera_file(lines))
    return seqs
