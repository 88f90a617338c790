"""Matérn SPDE discretization (Lindgren, Rue & Lindgren 2011), batched over chains.

Counterpart of ``tpu_gmrf.fem.spde``: (κ² − Δ)^{α/2} u = 𝒲 with α = ν + d/2;
K = κ²C̃ + G with lumped mass C̃; Q₁ = K, Q₂ = KᵀC⁻¹K,
Q_α = Kᵀ C⁻¹ Q_{α−2} C⁻¹ K; variance normalization
σ²_nat = Γ(ν)/(Γ(ν+d/2)(4π)^{d/2}κ^{2ν}); κ = √(8ν)/range.

κ is a tensor, a scalar or (B,) for B chains: K's data is G's data plus
κ²·C̃ embedded on the diagonal (``pad_to``, K5), and every product of the
α-recursion is a fixed-pattern SpGEMM (``sp_matmul``, K5), so the pattern
of Q does not depend on κ and one supernodal plan serves every θ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from ..gmrf import GMRF
from ..models.base import LatentModel, process_constraint
from ..solvers.base import SolverSpec
from ..sparse.matrix import SparseMatrix, spdiag
from ..sparse.pattern import diag_pattern, union_patterns
from .discretization import FEMDiscretization
from .mesh import generate_mesh

__all__ = ["MaternSPDE", "MaternModel", "range_to_kappa", "smoothness_to_nu"]


def range_to_kappa(range_, nu):
    return math.sqrt(8.0 * nu) / range_


def smoothness_to_nu(smoothness: int, d: int) -> float:
    if smoothness < 0:
        raise ValueError("smoothness must be non-negative")
    return smoothness + 1.0 if d % 2 == 0 else smoothness + 0.5


class MaternSPDE:
    """Matérn SPDE on a FEMDiscretization. Configuration object (static,
    host); `precision(kappa)` is the numeric map on kappa's device."""

    def __init__(
        self,
        disc: FEMDiscretization,
        smoothness: int = 1,
        variance: float = 1.0,
        diffusion_factor=None,
        bc: str = "neumann",
        boundary_noise: float = 1e-4,
    ):
        if bc not in ("neumann", "dirichlet"):
            raise ValueError("bc must be 'neumann' or 'dirichlet'")
        self.bc = bc
        self.boundary_noise = float(boundary_noise)
        self.disc = disc
        self.smoothness = int(smoothness)
        self.variance = float(variance)
        d = disc.intrinsic_dim
        self.d = d
        self.nu = smoothness_to_nu(self.smoothness, d)
        alpha = self.nu + d / 2.0
        if abs(alpha - round(alpha)) > 1e-9:
            raise ValueError(f"non-integer alpha {alpha}")
        self.alpha = int(round(alpha))
        self.C_diag = disc.mass_matrix(lumped=True).diagonal().numpy()  # (n,) host
        self.G = disc.stiffness_matrix(diffusion=diffusion_factor)
        n = disc.ndofs
        self.K_pattern = union_patterns(diag_pattern(n), self.G.pattern)
        if self.bc == "dirichlet":
            bmask = np.zeros(n, bool)
            bmask[disc.boundary_nodes()] = True
            self._bmask = bmask
        else:
            self._bmask = None
        self._consts: dict = {}

    @property
    def n(self):
        return self.disc.ndofs

    def _on(self, like: torch.Tensor) -> dict:
        """κ-independent tensors on `like`'s device and dtype, cached (with
        the Dirichlet masks, keyed by pattern and device)."""
        key = (str(like.device), like.dtype)
        c = self._consts.get(key)
        if c is None:
            dev, dt = like.device, like.dtype
            C = torch.as_tensor(self.C_diag, dtype=dt, device=dev)
            G = SparseMatrix(self.G.data.to(dev, dt), self.G.pattern).pad_to(self.K_pattern)
            c = dict(C=C, G=G, Cinv=spdiag(1.0 / C))
            self._consts[key] = c
        return c

    def _dirichlet(self, Q: SparseMatrix, value: float) -> SparseMatrix:
        """Zero the rows/cols of boundary dofs and set their diagonal to `value`."""
        key = (Q.pattern, str(Q.device))
        masks = self._consts.get(key)
        if masks is None:
            rows, cols = Q.pattern.rows, Q.pattern.cols
            # keep entries not touching the boundary; boundary diag handled below
            keep = ~(self._bmask[rows] | self._bmask[cols]) | (rows == cols)
            bpos = Q.pattern.diag_positions[np.nonzero(self._bmask)[0]]
            masks = (torch.as_tensor(keep, device=Q.device), torch.as_tensor(bpos, dtype=torch.long, device=Q.device))
            self._consts[key] = masks
        keep, bpos = masks
        data = torch.where(keep, Q.data, torch.zeros_like(Q.data))
        return Q.with_data(data.index_fill(-1, bpos, value))

    def K(self, kappa) -> SparseMatrix:
        kappa = as_tensor(kappa)
        c = self._on(kappa)
        k2c = (kappa**2)[..., None] * c["C"]
        K = spdiag(k2c).pad_to(self.K_pattern) + c["G"]
        if self._bmask is not None:
            # soft Dirichlet: decouple boundary dofs (zero row/col, unit diag)
            K = self._dirichlet(K, 1.0)
        return K

    def precision(self, kappa) -> SparseMatrix:
        """Q(κ) with the variance normalized to `self.variance`; κ scalar or (B,)."""
        kappa = as_tensor(kappa)
        K = self.K(kappa)
        Cinv = self._on(kappa)["Cinv"]
        alpha = self.alpha
        if alpha == 1:
            Q = K
        else:
            if alpha == 2:
                Q_rhs = Cinv
            else:
                Q_inner = self._recursion(K, alpha - 2, Cinv)
                Q_rhs = Cinv @ Q_inner @ Cinv
            Q = K.T @ (Q_rhs @ K)
        if self.nu > 0:
            sigma2_nat = (
                math.gamma(self.nu)
                / (math.gamma(self.nu + self.d / 2.0) * (4.0 * math.pi) ** (self.d / 2.0))
            ) * kappa ** (-2.0 * self.nu)
            Q = Q * (sigma2_nat / self.variance)
        if self._bmask is not None:
            # boundary dofs ~ N(0, boundary_noise²), independent
            Q = self._dirichlet(Q, self.boundary_noise ** (-2.0))
        return Q.symmetrize() if Q.pattern.is_symmetric else Q

    def _recursion(self, K, alpha, Cinv):
        if alpha == 1:
            return K
        if alpha == 2:
            return K.T @ (Cinv @ K)
        inner = self._recursion(K, alpha - 2, Cinv)
        return K.T @ ((Cinv @ inner @ Cinv) @ K)

    def discretize(self, kappa, solver: SolverSpec = SolverSpec()) -> GMRF:
        """The zero-mean GMRF of Q(κ), factored by `solver`."""
        Q = self.precision(kappa)
        return GMRF.from_precision(torch.zeros(self.n, dtype=Q.dtype, device=Q.device), Q, solver)


class MaternModel(LatentModel):
    """Latent Matérn model. Hyperparameters: (tau, range), each a scalar or
    (B,) for B chains."""

    name = "matern"

    def __init__(
        self,
        disc_or_points,
        smoothness: int = 1,
        constraint=None,
        solver=None,
        element_size=None,
        diffusion_factor=None,
        bc: str = "neumann",
        boundary_noise: float = 1e-4,
    ):
        if isinstance(disc_or_points, FEMDiscretization):
            disc = disc_or_points
            self.observation_points = None
        else:
            pts = np.asarray(disc_or_points, dtype=np.float64)
            disc = FEMDiscretization(generate_mesh(pts, element_size=element_size))
            self.observation_points = pts
        self.disc = disc
        self.spde = MaternSPDE(
            disc,
            smoothness=smoothness,
            diffusion_factor=diffusion_factor,
            bc=bc,
            boundary_noise=boundary_noise,
        )
        self.constraint = process_constraint(constraint, disc.ndofs)
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return self.disc.ndofs

    @property
    def hyperparameters(self):
        return ("tau", "range")

    def precision(self, tau, range) -> SparseMatrix:
        range = as_tensor(range)
        tau = torch.as_tensor(tau, dtype=range.dtype, device=range.device)
        return self.spde.precision(range_to_kappa(range, self.spde.nu)) * tau

    def constraints(self):
        return self.constraint

    def evaluation_matrix(self, points=None) -> SparseMatrix:
        if points is None:
            if self.observation_points is None:
                raise ValueError("no stored observation points; pass points")
            points = self.observation_points
        return self.disc.evaluation_matrix(points)
