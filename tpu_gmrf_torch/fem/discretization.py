"""P1 finite-element discretization on triangle meshes: closed-form assembly.

Counterpart of ``tpu_gmrf.fem.discretization``, on the host in NumPy:
lumped mass Mᵉ = A/3·δᵢⱼ, stiffness Gᵉᵢⱼ = A·(∇φᵢ·H·∇φⱼ) with constant
barycentric gradients. COO duplicates accumulate on the host once; the
matrices are handed over as the port's `SparseMatrix` (float64, CPU), whose
static patterns keep every θ-dependent combination (κ²C + G, ...) a fixed-
pattern operation. `evaluation_matrix`, which a caller multiplies with a
field, is on the package's default device. Interval meshes, surface meshes
and the advection and derivative operators come with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .mesh import TriangleMesh

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


class FEMDiscretization:
    """P1 Lagrange discretization on a planar TriangleMesh."""

    def __init__(self, mesh):
        if not isinstance(mesh, TriangleMesh):
            raise TypeError(f"unsupported mesh type {type(mesh)}")
        if mesh.embedding_dim != 2:
            raise NotImplementedError("surface meshes are not ported yet")
        self.mesh = mesh
        self._setup_triangles()

    # ---- geometry ----------------------------------------------------------

    def _setup_triangles(self):
        coords = self.mesh.element_coords()  # (m, 3, 2)
        e1 = coords[:, 1] - coords[:, 0]
        e2 = coords[:, 2] - coords[:, 0]
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
        g = self.grads  # (m, 3, d)
        if diffusion is not None:
            H = np.asarray(diffusion)
            gH = np.einsum("mkd,de->mke", g, H)
        else:
            gH = g
        Ge = np.einsum("mkd,mld->mkl", gH, g) * self.areas[:, None, None]
        rows, cols = self._tri_ij()
        return assemble_coo(rows, cols, Ge.ravel(), (n, n))

    # ---- evaluation --------------------------------------------------------

    def evaluation_matrix(self, points) -> SparseMatrix:
        """Sparse interpolation matrix: row p holds the P1 barycentric
        weights of `points[p]` in its containing element (closest element for
        points slightly outside); float64 on the default device."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = self.ndofs
        if pts.shape[1] != self.mesh.embedding_dim:
            raise ValueError("point dimension mismatch")
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
            bar = np.stack([w, u, v], axis=1)
            viol = np.maximum(-bar, 0.0).sum(axis=1)
            el = int(np.argmin(viol))
            b = np.clip(bar[el], 0.0, None)
            b = b / b.sum()
            rows_out += [p_idx] * 3
            cols_out += list(tris[el])
            vals_out += list(b)
        A = assemble_coo(rows_out, cols_out, vals_out, (len(pts), n))
        return SparseMatrix(A.data.to(default_device()), A.pattern)

    def boundary_nodes(self) -> np.ndarray:
        """Indices of boundary vertices (edges on exactly one triangle)."""
        t = self.mesh.triangles
        edges = np.concatenate(
            [t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0
        )
        edges = np.sort(edges, axis=1)
        uniq, counts = np.unique(edges, axis=0, return_counts=True)
        return np.unique(uniq[counts == 1])
