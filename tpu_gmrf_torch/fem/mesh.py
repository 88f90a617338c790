"""Host-side mesh generation (NumPy/SciPy).

Counterpart of ``tpu_gmrf.fem.mesh``: ``TriangleMesh``, ``auto_mesh_size``
and ``generate_mesh`` (convex hull + rounded inflation + graded Delaunay
fill + smoothing + Ruppert-style refinement), copied from the reference.
The one change: the final triangle filter tests centroids against the
rounded boundary chain with an even-odd ray-casting test written here,
where the reference calls ``matplotlib.path.Path.contains_points``
(matplotlib is not a dependency of the port). ``IntervalMesh``,
``create_inflated_rectangle`` and ``icosphere`` are the reference's, their
vertex and triangle order index for index.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull, Delaunay, cKDTree

__all__ = [
    "TriangleMesh",
    "IntervalMesh",
    "generate_mesh",
    "create_inflated_rectangle",
    "interval_mesh",
    "icosphere",
    "auto_mesh_size",
    "triangle_min_angles",
]


class TriangleMesh:
    """2D (or surface-embedded) P1 triangle mesh."""

    def __init__(self, vertices, triangles):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.triangles = np.asarray(triangles, dtype=np.int64)
        if self.triangles.ndim != 2 or self.triangles.shape[1] != 3:
            raise ValueError("triangles must be (m, 3)")

    @property
    def n_vertices(self):
        return self.vertices.shape[0]

    @property
    def n_elements(self):
        return self.triangles.shape[0]

    @property
    def embedding_dim(self):
        return self.vertices.shape[1]

    intrinsic_dim = 2

    def element_coords(self):
        return self.vertices[self.triangles]  # (m, 3, dim)


class IntervalMesh:
    """1D P1 mesh on sorted nodes."""

    def __init__(self, nodes):
        self.nodes = np.sort(np.asarray(nodes, dtype=np.float64))

    @property
    def n_vertices(self):
        return self.nodes.shape[0]

    @property
    def n_elements(self):
        return self.nodes.shape[0] - 1

    intrinsic_dim = 1
    embedding_dim = 1


def interval_mesh(a: float, b: float, n: int) -> IntervalMesh:
    return IntervalMesh(np.linspace(a, b, n))


def auto_mesh_size(points: np.ndarray) -> float:
    """Element size from median nearest-neighbor spacing (reference
    `auto_size_params`, ext/.../mesh_scattered.jl)."""
    if points.shape[0] < 2:
        return 1.0
    tree = cKDTree(points)
    d, _ = tree.query(points, k=2)
    med = float(np.median(d[:, 1]))
    return max(med, 1e-12) * 1.5


def _inflate_polygon(poly: np.ndarray, margin: float) -> np.ndarray:
    """Push convex-polygon vertices outward from the centroid by `margin`."""
    c = poly.mean(axis=0)
    d = poly - c
    norms = np.linalg.norm(d, axis=1, keepdims=True)
    return poly + d / np.maximum(norms, 1e-12) * margin


def triangle_min_angles(mesh: "TriangleMesh") -> np.ndarray:
    """Per-triangle minimum interior angle in degrees (quality metric)."""
    c = mesh.element_coords()
    out = []
    for k in range(3):
        u = c[:, (k + 1) % 3] - c[:, k]
        v = c[:, (k + 2) % 3] - c[:, k]
        cosang = np.einsum("ij,ij->i", u, v) / np.maximum(
            np.linalg.norm(u, axis=1) * np.linalg.norm(v, axis=1), 1e-300
        )
        out.append(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))
    return np.min(np.stack(out, axis=1), axis=1)


def generate_mesh(
    points,
    element_size=None,
    buffer_factor: float = 0.2,
    quality_iters: int = 30,
) -> TriangleMesh:
    """Mesh the (inflated) convex hull of scattered 2D points with a local
    sizing field and quality smoothing.

    The TPU-native stand-in for the reference's Gmsh pipeline
    (ext/GaussianMarkovRandomFieldsFEM/mesh_scattered.jl): a Threshold
    sizing field σ(x) = sizeMin → sizeMax as distance-to-data grows from
    distMin to distMax (reference `auto_size_params` constants α=0.8, β=3,
    γ=3), graded multi-resolution interior fill honoring σ, variable-radius
    pruning, and Lloyd-style Laplacian smoothing of the helper vertices
    (data points stay fixed as mesh vertices; periodic re-Delaunay supplies
    the edge flips). On irregular clouds this keeps minimum triangle
    angles ≳20° where the old uniform-grid fill produced slivers.
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError("points must be (N, 2)")
    if pts.shape[0] < 3:
        raise ValueError("need at least 3 points")

    tree = cKDTree(pts)
    d2, _ = tree.query(pts, k=2)
    d1 = d2[:, 1]
    dmed = max(float(np.median(d1)), 1e-12)
    dmin = max(float(d1.min()), 1e-12)
    if element_size is not None:
        size_min = size_max = float(element_size)
        dist_min, dist_max = dmin, 3.0 * dmed
    else:
        size_min, size_max = 0.8 * dmed, 3.0 * dmed
        dist_min, dist_max = dmin, 3.0 * dmed

    def sigma(x):
        dist = tree.query(np.atleast_2d(x))[0]
        t = np.clip((dist - dist_min) / max(dist_max - dist_min, 1e-12), 0.0, 1.0)
        return size_min + (size_max - size_min) * t

    hull = ConvexHull(pts)
    hpoly = pts[hull.vertices]
    diameter = float(np.max(hpoly.max(axis=0) - hpoly.min(axis=0)))
    margin = buffer_factor * diameter

    # Rounded offset boundary (Minkowski sum of the hull with a disk of
    # radius `margin`): each hull edge shifts outward along its normal and
    # corners become arcs. No sharp corners means Delaunay refinement never
    # fights the boundary — corner ping-pong was the round-3 sliver source.
    bseg = []
    nh = len(hpoly)
    for i in range(nh):
        a, b = hpoly[i], hpoly[(i + 1) % nh]
        e = b - a
        L = float(np.linalg.norm(e))
        if L < 1e-12:
            continue
        nrm = np.array([e[1], -e[0]]) / L  # outward for ccw hull? fix sign below
        # ensure outward: point away from centroid
        if np.dot(nrm, a - hpoly.mean(axis=0)) < 0:
            nrm = -nrm
        bseg.append(("edge", a + margin * nrm, b + margin * nrm))
        # arc at corner b from this edge's normal to the next edge's normal
        c_ = hpoly[(i + 1) % nh]
        e2 = hpoly[(i + 2) % nh] - c_
        L2 = float(np.linalg.norm(e2))
        nrm2 = np.array([e2[1], -e2[0]]) / max(L2, 1e-300)
        if np.dot(nrm2, c_ - hpoly.mean(axis=0)) < 0:
            nrm2 = -nrm2
        a1 = float(np.arctan2(nrm[1], nrm[0]))
        a2_ = float(np.arctan2(nrm2[1], nrm2[0]))
        while a2_ < a1:
            a2_ += 2 * np.pi
        bseg.append(("arc", c_, (a1, a2_)))
    bpts = []
    for kind, p1, p2 in bseg:
        if kind == "edge":
            L = float(np.linalg.norm(p2 - p1))
            u = (p2 - p1) / max(L, 1e-300)
            s = 0.0
            while s < L:
                p = p1 + s * u
                bpts.append(p)
                s += float(sigma(p)[0])
        else:
            c_, (a1, a2_) = p1, p2
            s = a1
            while s < a2_:
                p = c_ + margin * np.array([np.cos(s), np.sin(s)])
                bpts.append(p)
                s += float(sigma(p)[0]) / max(margin, 1e-300)
    bpts = np.asarray(bpts)
    # dedupe the chain against itself (edge→arc junctions can step short)
    if len(bpts) > 1:
        kb = cKDTree(bpts)
        keepb = np.ones(len(bpts), bool)
        sb = sigma(bpts)
        for i, j in sorted(kb.query_pairs(0.62 * size_max)):
            if keepb[i] and keepb[j]:
                if float(np.linalg.norm(bpts[i] - bpts[j])) < 0.45 * min(
                    sb[i], sb[j]
                ):
                    keepb[max(i, j)] = False
        bpts = bpts[keepb]
    poly = bpts  # the domain polygon IS the sampled rounded boundary

    # interior fill: multi-resolution grids banded by the sizing field
    lo, hi = poly.min(axis=0), poly.max(axis=0)
    tri_poly = Delaunay(poly)
    cands = []
    nlev = max(1, int(np.ceil(np.log2(max(size_max / size_min, 1.0)))) + 1)
    for lev in range(nlev):
        h = size_min * (2.0**lev)
        gx = np.arange(lo[0] - 0.5 * h * (lev % 2), hi[0] + h, h)
        gy = np.arange(lo[1] - 0.5 * h * ((lev + 1) % 2), hi[1] + h, h)
        grid = np.stack(np.meshgrid(gx, gy), axis=-1).reshape(-1, 2)
        grid = grid[tri_poly.find_simplex(grid) >= 0]
        if len(grid) == 0:
            continue
        sg = sigma(grid)
        band = (sg >= h / np.sqrt(2.0)) & (sg < h * np.sqrt(2.0))
        if lev == nlev - 1:
            band = sg >= h / np.sqrt(2.0)
        cands.append(grid[band])
    cand = np.vstack(cands) if cands else np.zeros((0, 2))

    allpts = np.vstack([pts, bpts, cand])
    sig_all = sigma(allpts)
    # variable-radius prune: earlier points win (data, then boundary, fill)
    kd = cKDTree(allpts)
    keep = np.ones(len(allpts), bool)
    for i, j in sorted(kd.query_pairs(0.62 * size_max)):
        if keep[i] and keep[j]:
            dij = float(np.linalg.norm(allpts[i] - allpts[j]))
            if dij < 0.62 * min(sig_all[i], sig_all[j]):
                keep[max(i, j)] = False
    keep[: len(pts) + len(bpts)] = True  # data + boundary chain always stay
    allpts = allpts[keep]
    # data points and every boundary-chain sample are pinned: qhull does NOT
    # report collinear straight-edge samples as hull vertices, so a
    # convex-hull test would let smoothing drag the boundary inward and
    # open giant chord slivers
    n_pinned = len(pts) + len(bpts)

    # Lloyd-style smoothing of helper vertices; pinned vertices stay fixed
    tri = Delaunay(allpts)
    for it in range(quality_iters):
        free = np.ones(len(allpts), bool)
        free[:n_pinned] = False
        simp = tri.simplices
        deg = np.zeros(len(allpts))
        acc = np.zeros_like(allpts)
        for k in range(3):
            a = simp[:, k]
            for k2 in range(3):
                if k2 == k:
                    continue
                np.add.at(acc, a, allpts[simp[:, k2]])
                np.add.at(deg, a, 1.0)
        target = acc / np.maximum(deg[:, None], 1.0)
        allpts[free] += 0.6 * (target[free] - allpts[free])
        if (it + 1) % 5 == 0 or it == quality_iters - 1:
            tri = Delaunay(allpts)

    # Delaunay refinement (simplified Ruppert): insert circumcenters of
    # low-quality triangles until the minimum angle clears the target.
    # Converges because each insertion removes the offending triangle and
    # the domain is convex with isolated fixed points.
    def _lloyd_once(allpts, tri, relax):
        free = np.ones(len(allpts), bool)
        free[:n_pinned] = False
        simp = tri.simplices
        deg = np.zeros(len(allpts))
        acc = np.zeros_like(allpts)
        for k in range(3):
            a = simp[:, k]
            for k2 in range(3):
                if k2 != k:
                    np.add.at(acc, a, allpts[simp[:, k2]])
                    np.add.at(deg, a, 1.0)
        tgt = acc / np.maximum(deg[:, None], 1.0)
        allpts[free] += relax * (tgt[free] - allpts[free])
        return allpts

    # Point-in-polygon via Delaunay of the (convex) rounded boundary chain:
    # find_simplex >= 0 ⇔ inside its convex hull. Slight centroid inflation
    # replicates the old radius-1e-6·diameter tolerance without pulling in
    # matplotlib (not a declared dependency).
    _pc = poly.mean(axis=0)
    _ptri = Delaunay(_pc + (poly - _pc) * (1.0 + 1e-6))

    class _chain:  # noqa: N801 — keep the call-site name
        @staticmethod
        def contains_points(p, radius=None):
            return _ptri.find_simplex(p) >= 0

    target = 20.5
    max_insert = 4 * len(allpts)
    inserted = 0
    cleanup_moves = 0
    for round_ in range(200):
        if round_ and round_ % 4 == 0:
            # interleaved relaxation keeps insertion fronts and boundary
            # transitions smooth so refinement converges instead of
            # chasing its own artifacts
            allpts = _lloyd_once(allpts, tri, 0.4)
            tri = Delaunay(allpts)
        m = TriangleMesh(allpts, tri.simplices)
        ang = triangle_min_angles(m)
        cc_all = allpts[tri.simplices]
        uu = cc_all[:, 1] - cc_all[:, 0]
        vv = cc_all[:, 2] - cc_all[:, 0]
        areas_now = 0.5 * np.abs(uu[:, 0] * vv[:, 1] - uu[:, 1] * vv[:, 0])
        # exactly-degenerate triangles (collinear boundary chains) and
        # triangles outside the boundary chain are dropped by the final
        # filter — don't refine them
        real = areas_now > 1e-9 * np.median(areas_now)
        real &= _chain.contains_points(
            cc_all.mean(axis=1), radius=1e-6 * diameter
        )
        bad = np.nonzero((ang < target) & real)[0]
        if len(bad) == 0 or inserted >= max_insert:
            break
        bad = bad[np.argsort(ang[bad])]
        # batch insertion must approximate sequential Ruppert: take only
        # vertex-disjoint worst triangles per round (bounded growth), so
        # one round's insertions don't collide and create new slivers
        cap = max(16, len(allpts) // 20)
        chosen, used = [], set()
        for t in bad:
            vs = tri.simplices[t]
            if any(int(v) in used for v in vs):
                continue
            chosen.append(t)
            used.update(int(v) for v in vs)
            if len(chosen) >= cap:
                break
        bad = np.asarray(chosen)
        c = allpts[tri.simplices[bad]]
        # circumcenters
        a_, b_, c_ = c[:, 0], c[:, 1], c[:, 2]
        d_ = 2.0 * (
            a_[:, 0] * (b_[:, 1] - c_[:, 1])
            + b_[:, 0] * (c_[:, 1] - a_[:, 1])
            + c_[:, 0] * (a_[:, 1] - b_[:, 1])
        )
        d_ = np.where(np.abs(d_) < 1e-300, 1e-300, d_)
        a2 = (a_**2).sum(1)
        b2 = (b_**2).sum(1)
        c2 = (c_**2).sum(1)
        ux = (a2 * (b_[:, 1] - c_[:, 1]) + b2 * (c_[:, 1] - a_[:, 1]) + c2 * (a_[:, 1] - b_[:, 1])) / d_
        uy = (a2 * (c_[:, 0] - b_[:, 0]) + b2 * (a_[:, 0] - c_[:, 0]) + c2 * (b_[:, 0] - a_[:, 0])) / d_
        cc = np.stack([ux, uy], axis=1)
        circumrad = np.linalg.norm(cc - a_, axis=1)
        # circumcenters outside the rounded domain: skip (the smooth
        # boundary is pre-sampled at σ, so these are rare; the rescue-move
        # branch below handles any leftover boundary sliver)
        inside_ = tri_poly.find_simplex(cc) >= 0
        cc, circumrad = cc[inside_], circumrad[inside_]
        # A Delaunay triangle's circumdisk is empty, so its circumcenter is
        # provably ≥ circumradius from every existing vertex — no proximity
        # rejection needed (that would block refining small input features,
        # e.g. near-coincident data points). Only dedupe within the batch,
        # scaled by each candidate's own circumradius.
        batch, brads = [], []
        exist = cKDTree(allpts)
        for p, R in zip(cc, circumrad):
            if R <= 1e-12 * diameter:
                continue
            # midpoint fallbacks lack the empty-disk guarantee: light check
            if exist.query(p[None, :])[0][0] < 1e-9:
                continue
            if batch:
                d0, i0 = cKDTree(np.asarray(batch)).query(p[None, :])
                if d0[0] < 0.9 * max(R, brads[int(i0[0])]):
                    continue
            batch.append(p)
            brads.append(R)
            inserted += 1
            if inserted >= max_insert:
                break
        if not batch:
            # insertion alone can't fix the remaining slivers (split-floor
            # corner cases) — smooth their free vertices locally instead,
            # then let refinement resume; stop after a few such rescues
            bad_verts = np.unique(tri.simplices[bad])
            movable = [int(v) for v in bad_verts if int(v) >= n_pinned]
            if not movable or cleanup_moves >= 12:
                break
            cleanup_moves += 1
            simp = tri.simplices
            deg = np.zeros(len(allpts))
            acc = np.zeros_like(allpts)
            for k in range(3):
                a = simp[:, k]
                for k2 in range(3):
                    if k2 != k:
                        np.add.at(acc, a, allpts[simp[:, k2]])
                        np.add.at(deg, a, 1.0)
            mv = np.asarray(movable)
            allpts[mv] = acc[mv] / np.maximum(deg[mv, None], 1.0)
            tri = Delaunay(allpts)
            continue
        allpts = np.vstack([allpts, np.asarray(batch)])
        tri = Delaunay(allpts)

    tris = tri.simplices
    coords = allpts[tris]
    u = coords[:, 1] - coords[:, 0]
    v = coords[:, 2] - coords[:, 0]
    areas = 0.5 * np.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0])
    # same threshold the refinement loop used to classify degenerate
    # (collinear-chain) triangles: anything below it covers no real area
    keep_t = areas > 1e-9 * np.median(areas)
    # drop triangles outside the rounded-boundary chain: Delaunay covers the
    # convex hull of all points, which includes hair-thin slivers between a
    # straight boundary chord and the sampled chain
    keep_t &= _inside_polygon(coords.mean(axis=1), poly)
    tris = tris[keep_t]
    return TriangleMesh(allpts, tris)


def _inside_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd ray casting of `points` (m, 2) against the closed polygon
    `poly` (k, 2), vectorized over the polygon's edges."""
    x, y = points[:, 0:1], points[:, 1:2]
    x0, y0 = poly[:, 0][None, :], poly[:, 1][None, :]
    x1, y1 = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    crosses = (y0 > y) != (y1 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
    return (np.count_nonzero(crosses & (x < xint), axis=1) % 2) == 1


def create_inflated_rectangle(
    x0: float, y0: float, x1: float, y1: float, h: float, buffer: float = 0.0
) -> TriangleMesh:
    """Structured triangulated rectangle [x0−b, x1+b] × [y0−b, y1+b], two
    triangles per grid cell."""
    lo_x, hi_x = x0 - buffer, x1 + buffer
    lo_y, hi_y = y0 - buffer, y1 + buffer
    nx = max(2, int(round((hi_x - lo_x) / h)) + 1)
    ny = max(2, int(round((hi_y - lo_y) / h)) + 1)
    xs = np.linspace(lo_x, hi_x, nx)
    ys = np.linspace(lo_y, hi_y, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    # cell (i, j) with corners a=(i, j), b=(i+1, j), c=(i+1, j+1), d=(i, j+1):
    # triangles [a, b, c] and [a, c, d], cells in row-major (i, j) order
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a, b = (i * ny + j).ravel(), ((i + 1) * ny + j).ravel()
    c, d = b + 1, a + 1
    tris = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], 1).reshape(-1, 3)
    return TriangleMesh(verts, tris)


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> TriangleMesh:
    """Triangulated sphere by icosahedron subdivision: each step puts a vertex
    at every edge's normalized midpoint (edges numbered in sorted order) and
    splits each face in four. `subdivisions=3` gives 642 vertices and 1280
    triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edges = np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
        )
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        inv = inv.ravel()
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(verts) + np.arange(len(uniq))
        verts = np.concatenate([verts, mids], axis=0)
        m = len(faces)
        ab, bc, ca = (
            mid_idx[inv[:m]],
            mid_idx[inv[m : 2 * m]],
            mid_idx[inv[2 * m :]],
        )
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        faces = np.concatenate(
            [
                np.stack([a, ab, ca], axis=1),
                np.stack([b, bc, ab], axis=1),
                np.stack([c, ca, bc], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ],
            axis=0,
        )
    return TriangleMesh(verts * radius, faces)
