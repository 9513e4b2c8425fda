"""darc: a simple append-only tensor archive.

Copy of `matryodshka_tpu/losses/elpips/darc.py` (numpy only; the two
read and write the same bytes). Functional equivalent of the reference's
single-file tensor database
(elpips/darc.py: DataArchive with append / index / name lookup), used by
the 2AFC training harness to store image triplets. The format here is a
clean reimplementation: a magic header, followed by
[name, dtype, shape, raw blob] records, with a JSON directory appended at
close (so interrupted writes lose only the index, which `repair` can
rebuild by scanning records).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"MDARC001"
_REC = struct.Struct("<I")  # u32 length prefixes


class DataArchive:
    """Append-only tensor archive.

    Modes: 'w' create, 'a' append, 'r' read. Read mode memory-maps blobs
    lazily via np.frombuffer on demand.
    """

    def __init__(self, path: str, mode: str = "r"):
        assert mode in ("r", "w", "a")
        self.path = path
        self.mode = mode
        self._index: List[dict] = []
        self._names = {}
        if mode == "w" or (mode == "a" and not os.path.exists(path)):
            self._fh = open(path, "wb+")
            self._fh.write(MAGIC)
            self._data_end = len(MAGIC)
        else:
            self._fh = open(path, "rb+" if mode == "a" else "rb")
            self._load_index()

    # -- write ------------------------------------------------------------
    def append(self, data: np.ndarray, name: Optional[str] = None) -> int:
        assert self.mode in ("w", "a")
        data = np.ascontiguousarray(data)
        idx = len(self._index)
        name = name if name is not None else str(idx)
        meta = {"name": name, "dtype": str(data.dtype),
                "shape": list(data.shape), "offset": self._data_end}
        header = json.dumps(meta).encode()
        self._fh.seek(self._data_end)
        self._fh.write(_REC.pack(len(header)))
        self._fh.write(header)
        blob = data.tobytes()
        self._fh.write(_REC.pack(len(blob)))
        self._fh.write(blob)
        self._data_end = self._fh.tell()
        self._index.append(meta)
        self._names[name] = idx
        return idx

    def close(self):
        if self._fh is None:
            return
        if self.mode in ("w", "a"):
            self._fh.seek(self._data_end)
            directory = json.dumps(self._index).encode()
            self._fh.write(directory)
            self._fh.write(struct.pack("<Q", len(directory)))
            self._fh.write(MAGIC)
        self._fh.close()
        self._fh = None

    # -- read -------------------------------------------------------------
    def _load_index(self):
        self._fh.seek(0)
        if self._fh.read(len(MAGIC)) != MAGIC:
            raise IOError(f"{self.path}: not a darc archive")
        self._fh.seek(-len(MAGIC) - 8, os.SEEK_END)
        tail = self._fh.read(8 + len(MAGIC))
        if tail[8:] != MAGIC:
            self._repair()
            return
        (dir_len,) = struct.unpack("<Q", tail[:8])
        self._fh.seek(-len(MAGIC) - 8 - dir_len, os.SEEK_END)
        self._index = json.loads(self._fh.read(dir_len))
        self._data_end = self._fh.tell() - dir_len
        self._names = {m["name"]: i for i, m in enumerate(self._index)}

    def _repair(self):
        """Rebuild the index by scanning records (torn-write recovery)."""
        self._fh.seek(0, os.SEEK_END)
        size = self._fh.tell()
        pos = len(MAGIC)
        self._index = []
        while pos + 4 <= size:
            self._fh.seek(pos)
            (hlen,) = _REC.unpack(self._fh.read(4))
            if pos + 4 + hlen + 4 > size:
                break
            try:
                meta = json.loads(self._fh.read(hlen))
            except ValueError:
                break
            (blen,) = _REC.unpack(self._fh.read(4))
            if pos + 4 + hlen + 4 + blen > size:
                break
            self._index.append(meta)
            pos += 4 + hlen + 4 + blen
        self._data_end = pos
        self._names = {m["name"]: i for i, m in enumerate(self._index)}

    def read(self, index) -> np.ndarray:
        if isinstance(index, str):
            index = self._names[index]
        meta = self._index[index]
        self._fh.seek(meta["offset"])
        (hlen,) = _REC.unpack(self._fh.read(4))
        self._fh.seek(hlen, os.SEEK_CUR)
        (blen,) = _REC.unpack(self._fh.read(4))
        blob = self._fh.read(blen)
        return np.frombuffer(blob, dtype=np.dtype(meta["dtype"])
                             ).reshape(meta["shape"]).copy()

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, index) -> np.ndarray:
        return self.read(index)

    def keys(self) -> List[str]:
        return [m["name"] for m in self._index]

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        for i, m in enumerate(self._index):
            yield m["name"], self.read(i)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
