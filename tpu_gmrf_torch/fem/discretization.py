"""P1 finite-element discretization: closed-form assembly on the host.

Counterpart of ``tpu_gmrf.fem.discretization``, in NumPy:
  triangle: lumped mass Mᵉ = A/3·δᵢⱼ (consistent (A/12)(1+δᵢⱼ)),
            stiffness Gᵉᵢⱼ = A·(∇φᵢ·H·∇φⱼ) with constant barycentric
            gradients, advection Bᵉᵢⱼ = (A/3)·(γ·∇φⱼ);
  interval: h/2 lumped mass, 1/h stiffness.
Surface meshes embedded in 3-D take their gradients in each element's plane
(a local orthonormal frame), and points off the surface are projected to
the closest point of the triangulation. COO duplicates accumulate on the
host once; the matrices are handed over as the port's `SparseMatrix`, whose
static patterns keep every θ-dependent combination (κ²C + G, ...) a fixed-
pattern operation. Mass, stiffness, advection and streamline matrices are
float64 on the CPU (their users move them); the observation operators
(`evaluation_matrix`, `derivative_matrix`, `second_derivative_matrix`,
`node_selection_matrix`), which a caller multiplies with a field, are
float64 on the package's default device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..sparse.matrix import SparseMatrix, spdiag
from ..sparse.pattern import SparsePattern
from .mesh import IntervalMesh, TriangleMesh

__all__ = ["FEMDiscretization", "assemble_coo"]


def assemble_coo(rows, cols, vals, shape) -> SparseMatrix:
    """Accumulate duplicate COO entries (host) into a canonical SparseMatrix."""
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals, dtype=np.float64).ravel()
    key = rows * shape[1] + cols
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, vals)
    pat = SparsePattern((uniq // shape[1]), (uniq % shape[1]), shape)
    # np.unique keys are sorted == canonical order
    return SparseMatrix(torch.as_tensor(acc, dtype=torch.float64), pat)


# the (points × triangles) pairs `_closest_point_bary` holds at once
_CLOSEST_PAIRS = 2_000_000


def _on_default(A: SparseMatrix) -> SparseMatrix:
    return SparseMatrix(A.data.to(default_device()), A.pattern)


def _closest_point_bary(pts: np.ndarray, coords: np.ndarray):
    """Closest point on a triangulated surface: for each 3D point, the
    containing/closest element and its barycentric weights (Ericson's
    region-classification algorithm, vectorized points × triangles on host).
    Returns (element (m,), barycentric weights (m, 3))."""
    step = max(1, _CLOSEST_PAIRS // max(1, coords.shape[0]))  # points per chunk
    if len(pts) > step:
        parts = [_closest_point_bary(pts[i : i + step], coords) for i in range(0, len(pts), step)]
        return np.concatenate([e for e, _ in parts]), np.concatenate([b for _, b in parts])
    a = coords[None, :, 0]  # (1, t, 3)
    ab = coords[None, :, 1] - a
    ac = coords[None, :, 2] - a
    p = pts[:, None, :]  # (m, 1, 3)
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - coords[None, :, 1]
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - coords[None, :, 2]
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    with np.errstate(divide="ignore", invalid="ignore"):
        v_edge_ab = d1 / (d1 - d3)
        w_edge_ac = d2 / (d2 - d6)
        w_edge_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        denom = 1.0 / np.where(va + vb + vc != 0, va + vb + vc, 1.0)
    v_in = vb * denom
    w_in = vc * denom
    zeros = np.zeros_like(d1)
    # region conditions, in Ericson's priority order
    conds = [
        (d1 <= 0) & (d2 <= 0),                       # vertex a
        (d3 >= 0) & (d4 <= d3),                      # vertex b
        (d6 >= 0) & (d5 <= d6),                      # vertex c
        (vc <= 0) & (d1 >= 0) & (d3 <= 0),           # edge ab
        (vb <= 0) & (d2 >= 0) & (d6 <= 0),           # edge ac
        (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), # edge bc
    ]
    vv = [zeros, np.ones_like(d1), zeros, v_edge_ab, zeros, 1.0 - w_edge_bc]
    ww = [zeros, zeros, np.ones_like(d1), zeros, w_edge_ac, w_edge_bc]
    v = np.select(conds, vv, default=v_in)
    w = np.select(conds, ww, default=w_in)
    v = np.clip(np.nan_to_num(v), 0.0, 1.0)
    w = np.clip(np.nan_to_num(w), 0.0, 1.0)
    closest = a + v[..., None] * ab + w[..., None] * ac  # (m, t, 3)
    diff = pts[:, None, :] - closest
    dist2 = (diff * diff).sum(-1)
    el = np.argmin(dist2, axis=1)
    ar = np.arange(len(pts))
    bar = np.stack([1.0 - v[ar, el] - w[ar, el], v[ar, el], w[ar, el]], axis=1)
    return el, bar


class FEMDiscretization:
    """P1 Lagrange discretization on a TriangleMesh or IntervalMesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        if isinstance(mesh, TriangleMesh):
            self._setup_triangles()
        elif isinstance(mesh, IntervalMesh):
            self._setup_intervals()
        else:
            raise TypeError(f"unsupported mesh type {type(mesh)}")

    # ---- geometry ----------------------------------------------------------

    def _setup_triangles(self):
        coords = self.mesh.element_coords()  # (m, 3, d)
        e1 = coords[:, 1] - coords[:, 0]
        e2 = coords[:, 2] - coords[:, 0]
        if coords.shape[2] == 2:
            det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            self.areas = 0.5 * np.abs(det)
            # constant barycentric gradients: ∇φᵢ = rot90(opposite edge)/2A
            p0, p1, p2 = coords[:, 0], coords[:, 1], coords[:, 2]

            def rot(v):
                return np.stack([-v[:, 1], v[:, 0]], axis=1)

            twoA = det[:, None]
            grad0 = rot(p2 - p1) / twoA
            grad1 = rot(p0 - p2) / twoA
            grad2 = rot(p1 - p0) / twoA
            self.grads = np.stack([grad0, grad1, grad2], axis=1)  # (m, 3, 2)
        else:
            # embedded surface: project to the element plane
            n = np.cross(e1, e2)
            norm_n = np.linalg.norm(n, axis=1)
            self.areas = 0.5 * norm_n
            # orthonormal local frame (t1, t2)
            t1 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
            t2 = np.cross(n / norm_n[:, None], t1)
            # local 2D coordinates of the three vertices
            loc = np.zeros((coords.shape[0], 3, 2))
            loc[:, 1, 0] = np.einsum("md,md->m", e1, t1)
            loc[:, 2, 0] = np.einsum("md,md->m", e2, t1)
            loc[:, 2, 1] = np.einsum("md,md->m", e2, t2)
            p0, p1, p2 = loc[:, 0], loc[:, 1], loc[:, 2]
            det = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
                p1[:, 1] - p0[:, 1]
            ) * (p2[:, 0] - p0[:, 0])

            def rot(v):
                return np.stack([-v[:, 1], v[:, 0]], axis=1)

            twoA = det[:, None]
            grad0_l = rot(p2 - p1) / twoA
            grad1_l = rot(p0 - p2) / twoA
            grad2_l = rot(p1 - p0) / twoA
            # lift local gradients back to embedding coords
            frame = np.stack([t1, t2], axis=1)  # (m, 2, d)
            self.grads = np.einsum(
                "mkl,mld->mkd", np.stack([grad0_l, grad1_l, grad2_l], axis=1), frame
            )

    def _setup_intervals(self):
        h = np.diff(self.mesh.nodes)
        self.h = h

    # ---- interface ---------------------------------------------------------

    @property
    def ndofs(self) -> int:
        return self.mesh.n_vertices

    @property
    def intrinsic_dim(self) -> int:
        return self.mesh.intrinsic_dim

    # ---- assembly ----------------------------------------------------------

    def _tri_ij(self):
        t = self.mesh.triangles
        rows = np.repeat(t, 3, axis=1).ravel()  # i index
        cols = np.tile(t, (1, 3)).ravel()  # j index
        return rows, cols

    def mass_matrix(self, lumped: bool = True) -> SparseMatrix:
        n = self.ndofs
        if isinstance(self.mesh, IntervalMesh):
            if lumped:
                d = np.zeros(n)
                np.add.at(d, np.arange(n - 1), self.h / 2)
                np.add.at(d, np.arange(1, n), self.h / 2)
                idx = np.arange(n)
                return assemble_coo(idx, idx, d, (n, n))
            rows = np.concatenate([np.arange(n - 1), np.arange(1, n), np.arange(n - 1), np.arange(1, n)])
            cols = np.concatenate([np.arange(n - 1), np.arange(1, n), np.arange(1, n), np.arange(n - 1)])
            vals = np.concatenate([self.h / 3, self.h / 3, self.h / 6, self.h / 6])
            return assemble_coo(rows, cols, vals, (n, n))
        A = self.areas
        if lumped:
            t = self.mesh.triangles
            d = np.zeros(n)
            for k in range(3):
                np.add.at(d, t[:, k], A / 3)
            idx = np.arange(n)
            return assemble_coo(idx, idx, d, (n, n))
        Me = (np.ones((3, 3)) + np.eye(3)) / 12.0  # × A
        vals = (A[:, None, None] * Me[None]).ravel()
        rows, cols = self._tri_ij()
        return assemble_coo(rows, cols, vals, (n, n))

    def stiffness_matrix(self, diffusion=None) -> SparseMatrix:
        n = self.ndofs
        if isinstance(self.mesh, IntervalMesh):
            inv_h = 1.0 / self.h
            m = n - 1
            i = np.arange(m)
            rows = np.concatenate([i, i + 1, i, i + 1])
            cols = np.concatenate([i, i + 1, i + 1, i])
            vals = np.concatenate([inv_h, inv_h, -inv_h, -inv_h])
            return assemble_coo(rows, cols, vals, (n, n))
        g = self.grads  # (m, 3, d)
        if diffusion is not None:
            H = np.asarray(diffusion)
            gH = np.einsum("mkd,de->mke", g, H)
        else:
            gH = g
        Ge = np.einsum("mkd,mld->mkl", gH, g) * self.areas[:, None, None]
        rows, cols = self._tri_ij()
        return assemble_coo(rows, cols, Ge.ravel(), (n, n))

    def advection_matrix(self, velocity) -> SparseMatrix:
        """Bᵢⱼ = ∫ φᵢ (γ·∇φⱼ): constant γ per mesh (vector) supported."""
        n = self.ndofs
        if isinstance(self.mesh, IntervalMesh):
            gamma = float(np.asarray(velocity).ravel()[0])
            m = n - 1
            # ∫ φ_i φ_j' over element: [[-1/2, 1/2], [-1/2, 1/2]] · γ
            i = np.arange(m)
            rows = np.concatenate([i, i, i + 1, i + 1])
            cols = np.concatenate([i, i + 1, i, i + 1])
            vals = gamma * np.concatenate(
                [-0.5 * np.ones(m), 0.5 * np.ones(m), -0.5 * np.ones(m), 0.5 * np.ones(m)]
            )
            return assemble_coo(rows, cols, vals, (n, n))
        gamma = np.asarray(velocity, dtype=np.float64)
        gdot = np.einsum("d,mkd->mk", gamma, self.grads)  # (m, 3) = γ·∇φ_j
        Be = np.repeat(
            (self.areas[:, None] / 3.0)[:, :, None] * gdot[:, None, :], 3, axis=1
        )
        rows, cols = self._tri_ij()
        return assemble_coo(rows, cols, Be.ravel(), (n, n))

    def streamline_diffusion_matrix(self, velocity, h: float = 0.1) -> SparseMatrix:
        """SUPG streamline-diffusion stabilization Sᵢⱼ = (h/|γ|)·∫ (γ·∇φᵢ)(γ·∇φⱼ)
        for advection-dominated SPDEs; `h` is the mesh-size normalization
        (`AdvectionDiffusionSPDE.discretize`'s, default 0.1)."""
        n = self.ndofs
        gamma = np.asarray(velocity, dtype=np.float64).ravel()
        gnorm = float(np.linalg.norm(gamma))
        if gnorm == 0.0:
            idx = np.zeros(1, dtype=np.int64)
            return assemble_coo(idx, idx, np.zeros(1), (n, n))
        scale = float(h) / gnorm
        if isinstance(self.mesh, IntervalMesh):
            g = gamma[0]
            m = n - 1
            # ∇φ = ±1/h_e ⇒ (γφ'ᵢ)(γφ'ⱼ)·h_e = γ²/h_e · [[1,-1],[-1,1]]
            v = scale * g * g / self.h
            i = np.arange(m)
            rows = np.concatenate([i, i + 1, i, i + 1])
            cols = np.concatenate([i, i + 1, i + 1, i])
            vals = np.concatenate([v, v, -v, -v])
            return assemble_coo(rows, cols, vals, (n, n))
        gdot = np.einsum("d,mkd->mk", gamma, self.grads)  # (m, 3)
        Se = scale * self.areas[:, None, None] * gdot[:, :, None] * gdot[:, None, :]
        rows, cols = self._tri_ij()
        return assemble_coo(rows, cols, Se.ravel(), (n, n))

    # ---- evaluation --------------------------------------------------------

    def evaluation_matrix(self, points) -> SparseMatrix:
        """Sparse interpolation matrix: row p holds the P1 barycentric
        weights of `points[p]` in its containing element (closest element for
        points slightly outside; on a surface, the closest point of the
        triangulation); float64 on the default device."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = self.ndofs
        if isinstance(self.mesh, IntervalMesh):
            nodes = self.mesh.nodes
            x = np.clip(pts.ravel(), nodes[0], nodes[-1])
            idx = np.clip(np.searchsorted(nodes, x) - 1, 0, n - 2)
            t = (x - nodes[idx]) / (nodes[idx + 1] - nodes[idx])
            rows = np.repeat(np.arange(len(x)), 2)
            cols = np.stack([idx, idx + 1], axis=1).ravel()
            vals = np.stack([1 - t, t], axis=1).ravel()
            return _on_default(assemble_coo(rows, cols, vals, (len(x), n)))
        if pts.shape[1] != self.mesh.embedding_dim:
            raise ValueError("point dimension mismatch")
        coords = self.mesh.element_coords()
        p0 = coords[:, 0]
        e1 = coords[:, 1] - coords[:, 0]
        e2 = coords[:, 2] - coords[:, 0]
        if self.mesh.embedding_dim == 2:
            det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            rows_out, cols_out, vals_out = [], [], []
            tris = self.mesh.triangles
            for p_idx, p in enumerate(pts):
                d = p[None, :] - p0
                u = (d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]) / det
                v = (e1[:, 0] * d[:, 1] - e1[:, 1] * d[:, 0]) / det
                w = 1.0 - u - v
                bar = np.stack([w, u, v], axis=1)
                viol = np.maximum(-bar, 0.0).sum(axis=1)
                el = int(np.argmin(viol))
                b = np.clip(bar[el], 0.0, None)
                b = b / b.sum()
                rows_out += [p_idx] * 3
                cols_out += list(tris[el])
                vals_out += list(b)
            return _on_default(assemble_coo(rows_out, cols_out, vals_out, (len(pts), n)))
        # embedded surface: closest-point projection onto the triangulation
        el, bar = _closest_point_bary(pts, coords)
        tris = self.mesh.triangles
        m = len(pts)
        rows = np.repeat(np.arange(m), 3)
        cols = tris[el].ravel()
        vals = bar.ravel()
        return _on_default(assemble_coo(rows, cols, vals, (m, n)))

    def boundary_nodes(self) -> np.ndarray:
        """Indices of boundary vertices (edges on exactly one triangle; the
        two endpoints for interval meshes)."""
        if isinstance(self.mesh, IntervalMesh):
            return np.array([0, self.mesh.n_vertices - 1], dtype=np.int64)
        t = self.mesh.triangles
        edges = np.concatenate(
            [t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0
        )
        edges = np.sort(edges, axis=1)
        uniq, counts = np.unique(edges, axis=0, return_counts=True)
        return np.unique(uniq[counts == 1])

    def derivative_matrix(self, points, dim: int = 0) -> SparseMatrix:
        """Row p = ∂φ/∂x_dim of the P1 basis at points[p] (constant per
        element), float64 on the default device: the operator of
        `PointDerivativeObsModel`."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = self.ndofs
        if isinstance(self.mesh, IntervalMesh):
            nodes = self.mesh.nodes
            x = np.clip(pts.ravel(), nodes[0], nodes[-1])
            idx = np.clip(np.searchsorted(nodes, x) - 1, 0, n - 2)
            h = nodes[idx + 1] - nodes[idx]
            rows = np.repeat(np.arange(len(x)), 2)
            cols = np.stack([idx, idx + 1], axis=1).ravel()
            vals = np.stack([-1.0 / h, 1.0 / h], axis=1).ravel()
            return _on_default(assemble_coo(rows, cols, vals, (len(x), n)))
        coords = self.mesh.element_coords()
        p0 = coords[:, 0]
        e1 = coords[:, 1] - coords[:, 0]
        e2 = coords[:, 2] - coords[:, 0]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        rows_out, cols_out, vals_out = [], [], []
        tris = self.mesh.triangles
        for p_idx, p in enumerate(pts):
            d = p[None, :] - p0
            u = (d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]) / det
            v = (e1[:, 0] * d[:, 1] - e1[:, 1] * d[:, 0]) / det
            w = 1.0 - u - v
            viol = np.maximum(-np.stack([w, u, v], axis=1), 0.0).sum(axis=1)
            el = int(np.argmin(viol))
            rows_out += [p_idx] * 3
            cols_out += list(tris[el])
            vals_out += list(self.grads[el, :, dim])
        return _on_default(assemble_coo(rows_out, cols_out, vals_out, (len(pts), n)))

    def second_derivative_matrix(self, points, dims=(0, 0)) -> SparseMatrix:
        """Row p = ∂²φ/∂x_{d2}∂x_{d1} at points[p] via nodal gradient
        recovery: P1 in-element Hessians vanish, so ∂u/∂x_{d1} is first
        L2-projected onto the nodal basis (lumped mass: g = M_l⁻¹ B_{d1} u
        with B_{d1,ij} = ∫ φᵢ ∂φⱼ/∂x_{d1}), then differentiated pointwise.
        The two products are formed on the host; the result is float64 on the
        default device."""
        d1, d2 = dims
        dim = (
            1
            if isinstance(self.mesh, IntervalMesh)
            else self.mesh.embedding_dim
        )
        e = np.zeros(dim)
        e[d1] = 1.0
        B = self.advection_matrix(e)  # ∫ φᵢ ∂φⱼ/∂x_{d1}
        Ml = self.mass_matrix(lumped=True)
        G1 = spdiag(1.0 / Ml.diagonal()) @ B  # nodal ∂/∂x_{d1} recovery
        Dm = self.derivative_matrix(points, dim=d2)
        return _on_default(SparseMatrix(Dm.data.cpu(), Dm.pattern) @ G1)

    def node_selection_matrix(self, node_idx) -> SparseMatrix:
        node_idx = np.asarray(node_idx, dtype=np.int64)
        m = len(node_idx)
        return _on_default(assemble_coo(np.arange(m), node_idx, np.ones(m), (m, self.ndofs)))
