"""Icosphere meshes, GCN support matrices and the pixel-to-vertex
barycentric lookup table: the GCN's mesh inputs.

A copy of `matryodshka_tpu/geometry/icosphere.py` (numpy only), so the
port imports nothing of the JAX package. The reference loads pre-pickled
Pixel2Mesh assets (sphere{subdiv}.dat with vertex coords and GCN support
matrices, p2v{subdiv}.npy with a per-pixel (3 vertices, 3 barycentric
weights) lookup, matryodshka/utils.py:36-53); they are generated here:

  * icosphere(subdiv): subdivided icosahedron, V = 10*4^s + 2 unit
    vertices (s=7 -> 163842, the reference's default).
  * support matrices: [I, D^-1/2 A D^-1/2] (symmetric-normalized
    adjacency), the standard 2-term GCN support stack.
  * p2v(subdiv, H, W): for every ERP pixel direction, the containing
    triangle's 3 vertex ids + barycentric weights (gnomonic projection),
    found via nearest-vertex + incident-face search; the tie-breaking is
    the JAX package's, bit for bit.

Results are cached as sphere{subdiv}_{H}x{W}.npz under a mesh dir, the
JAX package's file name and format, so either package reads the other's
cache. At subdiv 7 and 640x320 generation takes minutes of CPU, most of
it the p2v table's nearest-vertex search, which a cached file skips.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np



def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    return verts, faces


def icosphere(subdiv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivide the icosahedron `subdiv` times; vertices on the unit
    sphere. Returns (verts [V, 3] float32, faces [F, 3] int64)."""
    verts, faces = icosahedron()
    for _ in range(subdiv):
        edge_mid: Dict[Tuple[int, int], int] = {}
        new_verts = [v for v in verts]

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key in edge_mid:
                return edge_mid[key]
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            idx = len(new_verts)
            new_verts.append(m)
            edge_mid[key] = idx
            return idx

        new_faces = []
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(new_verts)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts.astype(np.float32), faces


def adjacency(num_verts: int, faces: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Undirected edge list (rows, cols) without duplicates."""
    edges = set()
    for a, b, c in faces:
        for i, j in ((a, b), (b, c), (c, a)):
            edges.add((int(i), int(j)))
            edges.add((int(j), int(i)))
    e = np.asarray(sorted(edges), dtype=np.int64)
    return e[:, 0], e[:, 1]


def support_matrices(verts: np.ndarray, faces: np.ndarray
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """GCN supports as COO triples (rows, cols, vals):
    [identity, D^-1/2 A D^-1/2]."""
    v = len(verts)
    rows, cols = adjacency(v, faces)
    deg = np.bincount(rows, minlength=v).astype(np.float64)
    norm = 1.0 / np.sqrt(deg)
    vals = (norm[rows] * norm[cols]).astype(np.float32)
    eye_idx = np.arange(v, dtype=np.int64)
    ident = (eye_idx, eye_idx, np.ones(v, np.float32))
    return [ident, (rows, cols, vals)]


def _pixel_dirs(height: int, width: int) -> np.ndarray:
    """Unit directions of ERP pixel centers, matching grids.lat_long_grid
    (same half-pixel constants) — pure numpy so mesh-asset generation
    never touches an accelerator."""
    s = np.linspace(-np.pi + np.pi / width, np.pi - np.pi / width, width,
                    dtype=np.float64)
    t = np.linspace(-np.pi / 2 + np.pi / (2 * height),
                    np.pi / 2 - np.pi / (2 * height), height,
                    dtype=np.float64)
    S, T = np.meshgrid(s, t)
    cosT = np.cos(T)
    return np.stack([np.cos(S) * cosT, np.sin(T), np.sin(S) * cosT],
                    axis=-1)


def _vert_faces_padded(verts: np.ndarray, faces: np.ndarray):
    """Vertex -> incident-face table padded to [V, 6] (icosphere degree
    is 5 or 6; pads repeat the first entry, which is selection-neutral:
    first-hit and first-argmax both pick the earliest occurrence)."""
    vert_faces: List[List[int]] = [[] for _ in range(len(verts))]
    for fi, f in enumerate(faces):
        for vid in f:
            vert_faces[int(vid)].append(fi)
    table = np.empty((len(verts), 6), np.int64)
    for vi, lst in enumerate(vert_faces):
        pad = lst + [lst[0]] * (6 - len(lst))
        table[vi] = pad[:6]
    return table


def pixel_to_vertex_lookup(verts: np.ndarray, faces: np.ndarray,
                           height: int, width: int) -> np.ndarray:
    """For each pixel: [(v_id, w), x3] -> array [W, H, 3, 2] (the
    reference's p2v layout, consumed by mesh_to_equirect at
    projector.py:293-332: transposed WxH with (index, weight) pairs).

    Fully vectorized: per-face gnomonic-barycentric solves become one
    precomputed batch of face-matrix inverses plus a chunked einsum over
    each pixel's <=6 candidate faces, reproducing the loop reference
    (`_pixel_to_vertex_lookup_loop`) exactly — first candidate whose
    normalized weights are all >= -1e-9 wins, else the best minimum.
    At subdiv 7 (163,842 verts) and 640x320 the nearest-vertex argmax
    over 34G candidate pairs dominates (minutes of CPU, against hours
    for the per-pixel loop); load_mesh_input caches the result on disk."""
    v = verts.astype(np.float64)
    dirs = _pixel_dirs(height, width).reshape(-1, 3)
    n = dirs.shape[0]

    vf = _vert_faces_padded(verts, faces)             # [V, 6]
    face_v = v[faces]                                  # [F, 3, 3]
    M = np.transpose(face_v, (0, 2, 1))                # columns a|b|c
    dets = np.linalg.det(M)
    ok_face = np.abs(dets) > 1e-300
    Minv = np.zeros_like(M)
    Minv[ok_face] = np.linalg.inv(M[ok_face])

    # nearest vertex per pixel (chunked matmul argmax; the [chunk, V]
    # score block is the memory hog at high subdivision — cap it).
    # float64 like the loop reference: near-tie pixels would pick a
    # different vertex (hence candidate-face set) under an f32 argmax.
    nearest = np.empty(n, np.int64)
    nchunk = max(1024, min(65536, (1 << 25) // max(1, len(verts))))
    vt = np.ascontiguousarray(v.T)
    for s in range(0, n, nchunk):
        d = dirs[s:s + nchunk] @ vt
        nearest[s:s + nchunk] = np.argmax(d, axis=1)

    out = np.zeros((n, 3, 2), np.float64)
    chunk = 65536
    for s in range(0, n, chunk):
        d = dirs[s:s + chunk]                          # [m, 3]
        cand = vf[nearest[s:s + chunk]]                # [m, 6]
        w = np.einsum("mkij,mj->mki", Minv[cand], d)   # [m, 6, 3]
        wsum = w.sum(axis=2)
        valid = (wsum > 0) & ok_face[cand]
        with np.errstate(divide="ignore", invalid="ignore"):
            wn = w / wsum[..., None]
        wmin = np.where(valid, wn.min(axis=2), -np.inf)
        hit = wmin >= -1e-9
        first_hit = np.argmax(hit, axis=1)
        best = np.argmax(wmin, axis=1)                 # first max on ties
        k = np.where(hit.any(axis=1), first_hit, best)
        rows = np.arange(d.shape[0])
        any_valid = valid.any(axis=1)
        wk = np.where(any_valid[:, None], wn[rows, k],
                      np.asarray([1.0, 0.0, 0.0]))
        fk = np.where(any_valid, cand[rows, k], cand[:, 0])
        wk = np.clip(wk, 0.0, None)
        wk = wk / wk.sum(axis=1, keepdims=True)
        out[s:s + chunk, :, 0] = faces[fk]
        out[s:s + chunk, :, 1] = wk

    # [H*W, 3, 2] -> [H, W, 3, 2] -> reference layout [W, H, 3, 2]
    return np.transpose(out.reshape(height, width, 3, 2),
                        (1, 0, 2, 3)).astype(np.float32)


def _pixel_to_vertex_lookup_loop(verts: np.ndarray, faces: np.ndarray,
                                 height: int, width: int) -> np.ndarray:
    """Per-pixel loop reference for pixel_to_vertex_lookup (tests only)."""
    v = verts.astype(np.float64)
    dirs = _pixel_dirs(height, width).reshape(-1, 3)

    vert_faces: List[List[int]] = [[] for _ in range(len(verts))]
    for fi, f in enumerate(faces):
        for vid in f:
            vert_faces[int(vid)].append(fi)

    n = dirs.shape[0]
    nearest = np.empty(n, np.int64)
    chunk = 65536
    for s in range(0, n, chunk):
        d = dirs[s:s + chunk] @ v.T
        nearest[s:s + chunk] = np.argmax(d, axis=1)

    out = np.zeros((n, 3, 2), np.float64)
    face_v = v[faces]  # [F, 3, 3]
    for i in range(n):
        d = dirs[i]
        best_w, best_f = None, None
        for fi in vert_faces[nearest[i]]:
            a, b, c = face_v[fi]
            # gnomonic barycentric: solve d ~ wa*a + wb*b + wc*c
            M = np.stack([a, b, c], axis=1)
            try:
                w = np.linalg.solve(M, d)
            except np.linalg.LinAlgError:
                continue
            if w.sum() <= 0:
                continue
            w = w / w.sum()
            if best_w is None or w.min() > best_w.min():
                best_w, best_f = w, fi
            if w.min() >= -1e-9:
                break
        if best_w is None:
            best_w = np.asarray([1.0, 0.0, 0.0])
            best_f = vert_faces[nearest[i]][0]
        best_w = np.clip(best_w, 0.0, None)
        best_w = best_w / best_w.sum()
        out[i, :, 0] = faces[best_f]
        out[i, :, 1] = best_w

    return np.transpose(out.reshape(height, width, 3, 2),
                        (1, 0, 2, 3)).astype(np.float32)


def load_mesh_input(subdiv: int, height: int, width: int,
                    cache_dir: str = "glob/train/gcn"):
    """Generate-or-load (coords, supports, p2v) — the utils.py:36-53
    surface, backed by generation instead of pickled assets."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir,
                        f"sphere{subdiv}_{height}x{width}.npz")
    if os.path.exists(path):
        z = np.load(path)
        supports = [(z[f"s{i}_rows"], z[f"s{i}_cols"], z[f"s{i}_vals"])
                    for i in range(int(z["n_supports"]))]
        return z["coords"], supports, z["p2v"]
    verts, faces = icosphere(subdiv)
    supports = support_matrices(verts, faces)
    p2v = pixel_to_vertex_lookup(verts, faces, height, width)
    blob = {"coords": verts, "p2v": p2v,
            "n_supports": np.asarray(len(supports))}
    for i, (r, c, vals) in enumerate(supports):
        blob[f"s{i}_rows"], blob[f"s{i}_cols"], blob[f"s{i}_vals"] = \
            r, c, vals
    np.savez(path, **blob)
    return verts, supports, p2v
