"""Marching-cubes surfel tables, generated programmatically.

The surface-distance engine needs, for each of the 256 binary 2x2x2
neighbourhood codes, the triangle area-vectors of the marching-cubes
isosurface patch inside that cell (the reference ships these as a
hand-written table, brats/lookup_tables.py; here they are *derived* from
the geometry at import time).

Construction: per code, every cube face contributes iso-segments joining
midpoints of its cut edges (standard MC face rules; the ambiguous
diagonal face case separates the positive corners, matching the classic
Lorensen-Cline tables). Segments chain into closed polygons; each polygon
is fan-triangulated and each triangle contributes its area vector
cross(b-a, c-a)/2, oriented away from the positive region.

Bit convention matches the reference's correlate kernel
(brats/sd_metrics.py:122-125): corner (i, j, k) of the 2x2x2 cell has
weight kernel[i][j][k] with kernel = [[[128, 64], [32, 16]], [[8, 4], [2, 1]]].

A copy of `fcd_tpu/metrics/mc_tables.py`, kept so that the port never imports
the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

# corner index (i, j, k) -> bit weight
_KERNEL = np.array([[[128, 64], [32, 16]], [[8, 4], [2, 1]]])

_CORNERS: List[Tuple[int, int, int]] = list(itertools.product((0, 1), repeat=3))


def _corner_bit(c) -> int:
    return int(_KERNEL[c[0], c[1], c[2]])


# cube edges: pairs of corners differing in exactly one axis
_EDGES: List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = []
for a in _CORNERS:
    for axis in range(3):
        if a[axis] == 0:
            b = list(a)
            b[axis] = 1
            _EDGES.append((a, tuple(b)))

# cube faces: 6 faces, each as (axis, value) with its 4 corners
_FACES = []
for axis in range(3):
    for val in (0, 1):
        corners = [c for c in _CORNERS if c[axis] == val]
        _FACES.append((axis, val, corners))


def _edge_key(a, b):
    return (a, b) if a <= b else (b, a)


def _midpoint(a, b):
    return (np.asarray(a, np.float64) + np.asarray(b, np.float64)) / 2.0


def _face_segments(face_corners, positive) -> List[Tuple[tuple, tuple]]:
    """Iso-segments on one face. Returns pairs of cut-edge keys."""
    # face edges: corner pairs within the face differing in one axis
    fc = face_corners
    edges = []
    for i in range(4):
        for j in range(i + 1, 4):
            diff = sum(x != y for x, y in zip(fc[i], fc[j]))
            if diff == 1:
                edges.append((fc[i], fc[j]))
    cut = [
        e for e in edges
        if (e[0] in positive) != (e[1] in positive)
    ]
    pos_in_face = [c for c in fc if c in positive]
    n_pos = len(pos_in_face)
    if n_pos in (0, 4) or not cut:
        return []
    if n_pos == 1 or n_pos == 3:
        assert len(cut) == 2
        return [(_edge_key(*cut[0]), _edge_key(*cut[1]))]
    # n_pos == 2
    a, b = pos_in_face
    adjacent = sum(x != y for x, y in zip(a, b)) == 1
    if adjacent:
        assert len(cut) == 2
        return [(_edge_key(*cut[0]), _edge_key(*cut[1]))]
    # diagonal (ambiguous): separate the positives — each positive corner
    # gets the segment joining its own two cut edges
    assert len(cut) == 4
    segs = []
    for p in (a, b):
        mine = [_edge_key(*e) for e in cut if p in e]
        assert len(mine) == 2
        segs.append((mine[0], mine[1]))
    return segs


def _polygons_for_code(code: int) -> List[List[tuple]]:
    positive = {c for c in _CORNERS if code & _corner_bit(c)}
    if not positive or len(positive) == 8:
        return []
    # gather all face segments
    segments = []
    for _, _, fc in _FACES:
        segments.extend(_face_segments(fc, positive))
    # chain segments into closed polygons (each cut edge appears in exactly 2 segments)
    adj: Dict[tuple, List[tuple]] = {}
    for s0, s1 in segments:
        adj.setdefault(s0, []).append(s1)
        adj.setdefault(s1, []).append(s0)
    polygons = []
    visited = set()
    for start in adj:
        if start in visited:
            continue
        poly = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxts = [n for n in adj[cur] if n != prev]
            # handle revisiting in degenerate double-link cases
            nxt = nxts[0] if nxts else adj[cur][0]
            if nxt == start:
                break
            poly.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        polygons.append(poly)
    return polygons


def _orient(tri_normal, positive, poly_pts):
    """Ensure the normal points away from the positive corners."""
    centroid = np.mean(poly_pts, axis=0)
    pos_centroid = np.mean([np.asarray(c, np.float64) for c in positive], axis=0)
    outward = centroid - pos_centroid
    if np.dot(tri_normal, outward) < 0:
        return -tri_normal
    return tri_normal


def generate_neighbour_code_to_normals() -> List[List[List[float]]]:
    """The 256-entry code -> [triangle area vectors] table, built from the
    classic MC connectivity in _mc_tri_table (exact parity with the
    reference's hand-written brats/lookup_tables.py up to triangle normal
    sign, which the metrics never use)."""
    from fcd_tpu_torch.metrics._mc_tri_table import _TRI_TABLE

    mids = [np.asarray(_midpoint(*e)) for e in _EDGES]
    table: List[List[List[float]]] = []
    for code in range(256):
        _, tris = _TRI_TABLE[code]
        normals: List[List[float]] = []
        for (e0, e1, e2) in tris:
            a, b, c = mids[e0], mids[e1], mids[e2]
            n = np.cross(b - a, c - a) / 2.0
            normals.append([float(v) for v in n])
        if not normals:
            normals = [[0.0, 0.0, 0.0]]
        table.append(normals)
    return table


_NORMALS_TABLE = None


def neighbour_code_to_normals() -> List[List[List[float]]]:
    global _NORMALS_TABLE
    if _NORMALS_TABLE is None:
        _NORMALS_TABLE = generate_neighbour_code_to_normals()
    return _NORMALS_TABLE


def create_table_neighbour_code_to_surface_area(spacing_mm) -> np.ndarray:
    """256-entry total surfel area per code for anisotropic spacing
    (brats/sd_metrics.py:57-71 semantics)."""
    s0, s1, s2 = spacing_mm
    table = neighbour_code_to_normals()
    areas = np.zeros(256)
    for code in range(256):
        normals = np.asarray(table[code], np.float64)
        scaled = normals * np.asarray([s1 * s2, s0 * s2, s0 * s1])
        areas[code] = np.linalg.norm(scaled, axis=1).sum()
    return areas
