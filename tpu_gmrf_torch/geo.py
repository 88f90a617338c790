"""Geospatial input: shapefile polygons → contiguity adjacency → Besag/BYM2.

Counterpart of ``tpu_gmrf.geo`` (reference
ext/GaussianMarkovRandomFieldsShapefile.jl / ...LibGEOS.jl:1-118): a
dependency-free reader of ESRI shapefile polygon geometry, and queen/rook
contiguity (shared vertex / shared edge) as a sparse 0/1 W for
`BesagModel` / `BYM2Model`. Host-side NumPy, run once at model-build time.

The contiguity is grouped with NumPy sorts instead of Python sets and
dicts: the same keys (vertices, or edges with their ends ordered, rounded
to `decimals`), the same W.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_shapefile_polygons", "contiguity_adjacency", "adjacency_from_shapefile"]


def read_shapefile_polygons(path: str):
    """Minimal ESRI .shp reader for shape types 5/15/25 (Polygon*).

    Returns a list of polygons; each polygon is a list of rings, each ring
    an (k, 2) float64 array of vertices. Null shapes are skipped. (Spec:
    ESRI Shapefile Technical Description, July 1998 — file header 100 bytes
    big-endian lengths, little-endian record payloads.)
    """
    polys = []
    with open(path, "rb") as f:
        header = f.read(100)
        if len(header) < 100:
            raise ValueError("not a shapefile: truncated header")
        (file_code,) = struct.unpack(">i", header[:4])
        if file_code != 9994:
            raise ValueError("not a shapefile: bad magic")
        (file_len_words,) = struct.unpack(">i", header[24:28])
        file_len = file_len_words * 2
        pos = 100
        while pos < file_len:
            rec_header = f.read(8)
            if len(rec_header) < 8:
                break
            _, content_len_words = struct.unpack(">ii", rec_header)
            content = f.read(content_len_words * 2)
            pos += 8 + content_len_words * 2
            (shape_type,) = struct.unpack("<i", content[:4])
            if shape_type == 0:  # null shape
                continue
            if shape_type not in (5, 15, 25):
                raise ValueError(f"unsupported shape type {shape_type} (want Polygon)")
            num_parts, num_points = struct.unpack("<ii", content[36:44])
            parts = np.frombuffer(content, dtype="<i4", count=num_parts, offset=44)
            pts = np.frombuffer(
                content, dtype="<f8", count=num_points * 2, offset=44 + 4 * num_parts
            ).reshape(num_points, 2)
            bounds = np.append(parts, num_points)
            rings = [pts[bounds[i] : bounds[i + 1]].copy() for i in range(num_parts)]
            polys.append(rings)
    return polys


def _ring_vertices(polygons, decimals: int):
    """(owner polygon, ring number, rounded vertex (k, 2)) of every ring vertex."""
    rings = [(i, np.asarray(ring, dtype=np.float64).reshape(-1, 2))
             for i, poly in enumerate(polygons) for ring in poly]
    if not rings:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, 2))
    sizes = [len(r) for _, r in rings]
    owner = np.repeat([i for i, _ in rings], sizes)
    ring = np.repeat(np.arange(len(rings)), sizes)
    return owner, ring, np.round(np.concatenate([r for _, r in rings]), decimals) + 0.0  # + 0.0: -0.0 as 0.0


def _vertex_keys(polygons, decimals: int):
    """(owner polygon, key (k, 2)) of every ring vertex."""
    owner, _, v = _ring_vertices(polygons, decimals)
    return owner, v


def _edge_keys(polygons, decimals: int):
    """(owner polygon, key (k, 4)) of every ring edge, its ends in lexicographic order."""
    owner, ring, v = _ring_vertices(polygons, decimals)
    same = ring[1:] == ring[:-1]
    a, b = v[:-1][same], v[1:][same]
    swap = (a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
    lo, hi = np.where(swap[:, None], b, a), np.where(swap[:, None], a, b)
    return owner[:-1][same], np.concatenate([lo, hi], axis=1)


def _shared_key_pairs(owner, keys):
    """(a, b), a ≠ b, for every two polygons that hold one key."""
    order = np.lexsort((owner,) + tuple(keys[:, c] for c in reversed(range(keys.shape[1]))))
    owner, keys = owner[order], keys[order]
    new_key = np.ones(len(owner), dtype=bool)
    new_key[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    keep = new_key.copy()
    keep[1:] |= owner[1:] != owner[:-1]  # one entry per (key, polygon)
    owner, new_key = owner[keep], new_key[keep]
    start = np.flatnonzero(new_key)
    size = np.diff(np.append(start, len(owner)))
    group = np.cumsum(new_key) - 1
    k = size[group]  # each entry pairs with every entry of its group
    first = np.repeat(np.arange(len(owner)), k)
    offset = np.arange(len(first)) - np.repeat(np.cumsum(k) - k, k)
    second = np.repeat(start[group], k) + offset
    pair = first != second
    return owner[first[pair]], owner[second[pair]]


def contiguity_adjacency(polygons, criterion: str = "queen", decimals: int = 8):
    """Queen (shared vertex) or rook (shared edge) contiguity.

    polygons: list of list-of-rings as returned by
    `read_shapefile_polygons`. Returns a symmetric scipy CSR 0/1 matrix.
    Keys are grouped by a sort, so the cost is O(V log V) in the total
    vertex count V, not O(n²) pairwise tests.
    """
    import scipy.sparse as sp

    n = len(polygons)
    keyed = _vertex_keys if criterion == "queen" else _edge_keys
    rows, cols = _shared_key_pairs(*keyed(polygons, decimals))
    W = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    W.data[:] = 1.0  # collapse duplicates from multiple shared keys
    W.sum_duplicates()
    W.data[:] = 1.0
    return W


def adjacency_from_shapefile(path: str, criterion: str = "queen"):
    """Shapefile → contiguity W, ready for `BesagModel(W)` / `BYM2Model(W)`."""
    return contiguity_adjacency(read_shapefile_polygons(path), criterion=criterion)
