"""Marching-cubes tables, derived algorithmically at import time.

Same cube/edge numbering as the reference (Paul Bourke's public
convention, ref: src/MarchingCubes/MC_edge_table.cu:6-44):

  corner k offset (dx, dy, dz):
    0:(0,0,1) 1:(1,0,1) 2:(1,0,0) 3:(0,0,0)
    4:(0,1,1) 5:(1,1,1) 6:(1,1,0) 7:(0,1,0)
  edge k connects corners:
    0:(0,1) 1:(1,2) 2:(2,3) 3:(3,0) 4:(4,5) 5:(5,6) 6:(6,7) 7:(7,4)
    8:(0,4) 9:(1,5) 10:(2,6) 11:(3,7)

Rather than transcribing the canonical 256-entry triangle table, it is
*derived*: for each sign configuration, crossing points on each face are
paired so that segments isolate the face's OUTSIDE corners (a rule that
depends only on the face's sign pattern, hence agrees between the two
cubes sharing a face -> globally watertight meshes, which the canonical
Lorensen table is not in ambiguous cases); segments chain into loops;
loops are oriented so triangle normals point toward positive TSDF
(outside) and fan-triangulated. tests/test_marching_cubes.py checks the
derivation: closed sphere meshes (every edge shared by exactly two
triangles), complement symmetry, and edge-set consistency.
"""

from __future__ import annotations

import numpy as np

CORNER_OFFSETS = np.array(
    [
        (0, 0, 1),
        (1, 0, 1),
        (1, 0, 0),
        (0, 0, 0),
        (0, 1, 1),
        (1, 1, 1),
        (1, 1, 0),
        (0, 1, 0),
    ],
    dtype=np.int32,
)  # (corner, (dx, dy, dz))

EDGE_CORNERS = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
    dtype=np.int32,
)  # (edge, (corner_a, corner_b))

# Each face: its 4 corners in cyclic order; edges[i] connects
# corners[i] -> corners[i+1].
_FACES = [
    ([0, 1, 2, 3], [0, 1, 2, 3]),      # y = 0
    ([4, 5, 6, 7], [4, 5, 6, 7]),      # y = 1
    ([0, 3, 7, 4], [3, 11, 7, 8]),     # x = 0
    ([1, 5, 6, 2], [9, 5, 10, 1]),     # x = 1
    ([3, 2, 6, 7], [2, 10, 6, 11]),    # z = 0
    ([0, 4, 5, 1], [8, 4, 9, 0]),      # z = 1
]

# Widest triangulation the derivation produces (checked at build time).
MAX_TRIS = 8


def _face_segments(inside, corners, edges):
    """Pair a face's crossing edges into segments.

    Rule: each segment isolates an OUTSIDE corner (walks around it).
    With 2 crossings there is one pairing; with 4 (ambiguous face) the
    rule picks the pairing cutting off the two outside corners.
    """
    crossing = [
        e
        for i, e in enumerate(edges)
        if inside[corners[i]] != inside[corners[(i + 1) % 4]]
    ]
    if not crossing:
        return []
    segs = []
    # walk the cycle; pair edge i with edge i+1 when the shared corner
    # (corners[i+1]) is outside
    pairs_done = set()
    for i in range(4):
        e_a, e_b = edges[i], edges[(i + 1) % 4]
        shared = corners[(i + 1) % 4]
        if e_a in crossing and e_b in crossing and not inside[shared]:
            key = frozenset((e_a, e_b))
            if key not in pairs_done:
                segs.append((e_a, e_b))
                pairs_done.add(key)
    # 2-crossing faces: the two crossings may not be cyclically adjacent
    # (opposite edges) or the shared corner may be inside on both walks;
    # fall back to pairing the (exactly two) crossing edges directly.
    used = {e for s in segs for e in s}
    rest = [e for e in crossing if e not in used]
    if len(rest) == 2:
        segs.append((rest[0], rest[1]))
    assert not (len(rest) % 2), (inside, corners, edges, segs)
    return segs


def _loops_for_config(config: int):
    inside = [(config >> k) & 1 == 1 for k in range(8)]
    segs = []
    for corners, edges in _FACES:
        segs.extend(_face_segments(inside, corners, edges))
    # adjacency: each crossing edge appears in exactly 2 segments
    adj = {}
    for a, b in segs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    for e, ns in adj.items():
        assert len(ns) == 2, (config, adj)
    loops = []
    visited = set()
    for start in sorted(adj):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [n for n in adj[cur] if n != prev]
            # both neighbours equal prev (2-edge loop) -> take either
            nxt = nxt[0] if nxt else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        assert len(loop) >= 3, (config, loop)
        loops.append(loop)
    return inside, loops


def _orient(loop, inside):
    """Orient the loop so its normal points toward outside (positive)."""
    # edge midpoints as proxy geometry
    mids = []
    outward = np.zeros(3)
    for e in loop:
        a, b = EDGE_CORNERS[e]
        pa = CORNER_OFFSETS[a].astype(np.float64)
        pb = CORNER_OFFSETS[b].astype(np.float64)
        mids.append((pa + pb) / 2.0)
        if inside[a]:
            outward += pb - pa
        else:
            outward += pa - pb
    mids = np.array(mids)
    normal = np.zeros(3)
    for i in range(len(mids)):
        a = mids[i]
        b = mids[(i + 1) % len(mids)]
        normal += np.cross(a, b)
    if np.dot(normal, outward) < 0:
        return loop[::-1]
    return loop


def _build_tables():
    tri_table = np.full((256, MAX_TRIS * 3), -1, dtype=np.int32)
    tri_counts = np.zeros(256, dtype=np.int32)
    edge_table = np.zeros(256, dtype=np.int32)
    for config in range(256):
        inside, loops = _loops_for_config(config)
        tris = []
        for loop in loops:
            loop = _orient(loop, inside)
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        assert len(tris) <= MAX_TRIS, (config, len(tris))
        tri_counts[config] = len(tris)
        flat = [e for t in tris for e in t]
        tri_table[config, : len(flat)] = flat
        mask = 0
        for e in set(x for t in tris for x in t):
            mask |= 1 << e
        edge_table[config] = mask
    return tri_table, tri_counts, edge_table


TRI_TABLE, TRI_COUNTS, EDGE_TABLE = _build_tables()
VERT_COUNTS = TRI_COUNTS * 3
