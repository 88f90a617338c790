"""Spatiotemporal GMRFs: implicit-Euler advection-diffusion SSM joints and
Kronecker product space-time models.

Counterpart of ``tpu_gmrf.fem.spatiotemporal``:
- advection-diffusion (Clarotto 2024):
  [∂t + 1/c(κ² − ∇·H∇)^α + 1/c γ·∇]X = τ/√c Z, implicit Euler;
- the linear SSM's block-tridiagonal joint precision
  diag = [Q₀+AᵀF⁻¹A, F⁻¹+AᵀF⁻¹A, …, F⁻¹], off-diag = −F⁻¹A with
  F⁻¹ = GᵀΣ⁻¹G, A = G⁻¹M, Σ⁻¹ = M⁻ᵀβ⁻ᵀQ_sβ⁻¹M⁻¹;
- Q_st = Q_t ⊗ Q_s (time ⊗ space, space fastest);
- per-time-slice statistics of the joint.

All per-step blocks are constant (constant mesh, uniform Δt), so the joint
precision assembles once as a fixed-pattern block-tridiagonal SparseMatrix.
The blocks are formed on the default device: every product is a fixed-
pattern SpGEMM (``sp_matmul``, K5), also on the non-symmetric patterns of
G_dt and Gᵀ; only the final ``symmetrize`` makes the joint symmetric.
``sp_block_tridiag`` places the blocks by ``sp_bmat``: one sort of the
joint's coordinates on the host, one gather of the blocks' data.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..gmrf import GMRF
from ..inference.joint import sp_bmat
from ..solvers.base import DENSE_AUTO_MAX, SolverSpec
from ..sparse.matrix import SparseMatrix, sp_kron, spdiag
from ..sparse.pattern import SparsePattern
from .discretization import FEMDiscretization
from .mesh import interval_mesh
from .spde import MaternSPDE

__all__ = [
    "SpatiotemporalGMRF",
    "AdvectionDiffusionSPDE",
    "kronecker_product_spatiotemporal_model",
    "product_matern",
    "spatial_to_spatiotemporal",
    "sp_block_tridiag",
]

def sp_block_tridiag(diag_blocks, off_blocks) -> SparseMatrix:
    """Symmetric block tridiagonal from Nt diagonal blocks and Nt−1
    sub-diagonal blocks (off at (i+1, i); transpose mirrored). Data (nnz,) or
    (B, nnz), chain axes broadcast; `sp_bmat` sorts the joint's coordinates
    once and places every block's data with one gather."""
    Nt = len(diag_blocks)
    grid = [[None] * Nt for _ in range(Nt)]
    for i, b in enumerate(diag_blocks):
        grid[i][i] = b
    for i, b in enumerate(off_blocks):
        grid[i + 1][i], grid[i][i + 1] = b, b.T
    return sp_bmat(grid)


class SpatiotemporalGMRF:
    """GMRF wrapper with per-time-slice statistics; a chain axis of the
    joint leads each statistic's (N_t, N_s)."""

    def __init__(self, gmrf: GMRF, N_t: int, disc: FEMDiscretization, ts=None):
        self.gmrf = gmrf
        self.N_t = N_t
        self.disc = disc
        self.ts = ts
        self.N_s = gmrf.n // N_t

    # forwarding
    def __getattr__(self, name):
        if name == "gmrf":
            raise AttributeError(name)
        return getattr(self.gmrf, name)

    def __len__(self):
        return self.gmrf.n

    def _slices(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.N_t, self.N_s)

    def time_means(self):
        return self._slices(self.gmrf.mean)

    def time_vars(self):
        return self._slices(self.gmrf.var())

    def time_stds(self):
        return torch.sqrt(self.time_vars())

    def time_rands(self, generator: torch.Generator, shape=()):
        """Draws of the joint as (*shape, *batch, N_t, N_s)."""
        return self._slices(self.gmrf.sample(generator, tuple(shape)))

    def discretization_at_time(self, t):
        return self.disc


def spatial_to_spatiotemporal(A_spatial: SparseMatrix, t_idx: int, N_t: int) -> SparseMatrix:
    """Lift a spatial observation matrix to the joint space-time vector at
    time index t."""
    m, Ns = A_spatial.shape
    pat = A_spatial.pattern
    cols = pat.cols.astype(np.int64) + t_idx * Ns
    new_pat = SparsePattern(pat.rows, cols, (m, Ns * N_t))
    order = torch.as_tensor(new_pat.sort_order, device=A_spatial.device)
    return SparseMatrix(A_spatial.data[..., order], new_pat)


def _constrained_data(A: SparseMatrix, keep: np.ndarray, mask: np.ndarray, diag_value) -> SparseMatrix:
    """A with the entries outside `keep` zeroed and the diagonal of the
    masked rows set to `diag_value`."""
    dev = A.device
    data = torch.where(torch.as_tensor(keep, device=dev), A.data, torch.zeros_like(A.data))
    dpos = torch.as_tensor(A.pattern.diag_positions[np.nonzero(mask)[0]], dtype=torch.long, device=dev)
    return A.with_data(data.index_fill(-1, dpos, diag_value))


def _decouple_rows_cols(A: SparseMatrix, mask: np.ndarray, diag_value) -> SparseMatrix:
    """Zero every entry whose row or column is constrained; set constrained
    diagonal entries to `diag_value` (the hard application of a Dirichlet
    constraint, and the symmetric half of the soft one)."""
    rows, cols = A.pattern.rows, A.pattern.cols
    return _constrained_data(A, ~(mask[rows] | mask[cols]), mask, diag_value)


def _zero_rows(A: SparseMatrix, mask: np.ndarray, diag_value=1.0) -> SparseMatrix:
    """Zero constrained *rows* only and set their diagonal to `diag_value`:
    the soft-constraint transform of the propagation operator (K[p,:] = 0,
    K[p,p] = 1)."""
    return _constrained_data(A, ~mask[A.pattern.rows], mask, diag_value)


def _gmres(matvec, b: torch.Tensor, diag: torch.Tensor, tol: float, maxiter: int, restart: int = 20):
    """Restarted GMRES(restart) for A x = b with left Jacobi preconditioning
    (M = diag(A)⁻¹): at most `maxiter` restart cycles, stopping once
    ‖M(b − Ax)‖ ≤ tol·‖Mb‖, as ``jax.scipy.sparse.linalg.gmres`` does."""
    x = torch.zeros_like(b)
    atol = tol * torch.linalg.vector_norm(b / diag)
    for _ in range(maxiter):
        r = (b - matvec(x)) / diag
        beta = torch.linalg.vector_norm(r)
        if beta <= atol:
            break
        V = [r / beta]
        H = torch.zeros(restart + 1, restart, dtype=b.dtype, device=b.device)
        for j in range(restart):
            w = matvec(V[j]) / diag
            for i in range(j + 1):  # modified Gram-Schmidt
                H[i, j] = torch.dot(V[i], w)
                w = w - H[i, j] * V[i]
            H[j + 1, j] = torch.linalg.vector_norm(w)
            V.append(w / H[j + 1, j])
        e1 = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        y = torch.linalg.lstsq(H, e1[:, None]).solution[:, 0]
        x = x + torch.stack(V[:restart], 1) @ y
    return x


def _ssm_means(G_dt: SparseMatrix, M_diag, mu0, Nt: int, bnodes, bvals, dense_max: int):
    """Per-step SSM means μᵢ = G⁻¹(M μᵢ₋₁) with Dirichlet rows forced to the
    prescribed values, (Nt·Ns,). Constant blocks: one LU of the dense G_dt
    for Ns ≤ `dense_max`, else Jacobi-preconditioned GMRES on G_dt's
    matvec (K4) at tol 1e-10 and at most 400 restarts; a host loop over
    the Nt−1 steps."""
    Ns = G_dt.shape[0]
    dev, dt = G_dt.device, G_dt.dtype
    mu = torch.as_tensor(mu0, dtype=dt, device=dev).expand(Ns)
    has_b = bnodes is not None and len(bnodes) > 0
    if has_b:
        bidx = torch.as_tensor(np.asarray(bnodes), dtype=torch.long, device=dev)
        bv = torch.tensor(np.array(bvals, dtype=np.float64), dtype=dt, device=dev)
    if Ns <= dense_max:
        lu, piv = torch.linalg.lu_factor(G_dt.todense())

        def solve(rhs):
            return torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]

    else:
        diag = G_dt.diagonal()

        def solve(rhs):
            return _gmres(G_dt.matvec, rhs, diag, tol=1e-10, maxiter=400)

    mus = [mu]
    for _ in range(Nt - 1):
        rhs = M_diag * mus[-1]
        if has_b:
            rhs = rhs.index_put((bidx,), bv)
        mus.append(solve(rhs))
    return torch.cat(mus)


class AdvectionDiffusionSPDE:
    """Advection-diffusion SPDE over a constant spatial mesh.

    Static configuration: kappa, alpha (integer), H, gamma, c, tau are fixed
    at construction; `discretize` assembles the joint space-time GMRF
    (float64, on the default device) for given time points, propagating
    per-step means μᵢ = G⁻¹(M μᵢ₋₁) and applying soft Dirichlet
    constraints.
    """

    def __init__(
        self,
        disc: FEMDiscretization,
        gamma,
        kappa: float = 1.0,
        alpha: int = 1,
        H=None,
        c: float = 1.0,
        tau: float = 1.0,
        spatial_smoothness: int = 1,
        initial_smoothness: int = 2,
        bc: str = "neumann",
        constraint_noise: float = 1e-4,
        spatial_kappa: float | None = None,
    ):
        if bc not in ("neumann", "dirichlet"):
            raise ValueError("bc must be 'neumann' or 'dirichlet'")
        self.disc = disc
        self.kappa = float(kappa)
        # the propagation κ (the (κ²−∇·H∇)^α drift) is decoupled from the κ
        # of the spatial-noise and initial-condition Matérns
        self.spatial_kappa = float(kappa if spatial_kappa is None else spatial_kappa)
        self.alpha = int(alpha)
        self.H = H
        self.gamma = np.asarray(gamma, dtype=np.float64)
        self.c = float(c)
        self.tau = float(tau)
        self.bc = bc
        self.constraint_noise = float(constraint_noise)
        # the initial and spatial SPDEs inherit the constraint, so that the
        # SSM chain anchors at a constrained x₀ and the boundary is pinned
        self.spatial_spde = MaternSPDE(
            disc, smoothness=spatial_smoothness, diffusion_factor=H,
            bc=bc, boundary_noise=constraint_noise,
        )
        self.initial_spde = MaternSPDE(
            disc, smoothness=initial_smoothness, diffusion_factor=H,
            bc=bc, boundary_noise=constraint_noise,
        )

    def discretize(
        self,
        ts,
        mean_offset: float = 0.0,
        streamline_diffusion: bool = False,
        h: float = 0.1,
        boundary_values=0.0,
        solver: SolverSpec = SolverSpec(),
    ) -> SpatiotemporalGMRF:
        mean, Q_joint = self._assemble(ts, mean_offset, streamline_diffusion, h, boundary_values)
        joint = GMRF.from_precision(mean, Q_joint, solver)
        return SpatiotemporalGMRF(joint, len(ts), self.disc, ts=np.asarray(ts, dtype=np.float64))

    def _assemble(self, ts, mean_offset=0.0, streamline_diffusion=False, h=0.1, boundary_values=0.0):
        """(mean, joint precision) of `discretize`, unfactored."""
        ts = np.asarray(ts, dtype=np.float64)
        dt = float(ts[1] - ts[0])
        disc = self.disc
        Ns = disc.ndofs
        Nt = len(ts)
        dev = default_device()

        def on(A: SparseMatrix) -> SparseMatrix:
            return SparseMatrix(A.data.to(dev), A.pattern)

        M = on(disc.mass_matrix(lumped=True))  # diagonal
        G = on(disc.stiffness_matrix(diffusion=self.H))
        B = on(disc.advection_matrix(self.gamma))
        if float(np.linalg.norm(self.gamma)) == 0.0:
            streamline_diffusion = False  # SD changes nothing for zero advection

        bmask = np.zeros(Ns, dtype=bool)
        bnodes = None
        if self.bc == "dirichlet":
            bnodes = disc.boundary_nodes()
            bmask[bnodes] = True
            # hard-apply to the assembled operators
            M = _decouple_rows_cols(M, bmask, 1.0)
            G = _decouple_rows_cols(G, bmask, 0.0)
            B = _decouple_rows_cols(B, bmask, 0.0)

        # K = (κ²M + G)^α
        Kbase = spdiag(self.kappa**2 * M.diagonal()) + G
        K = Kbase
        for _ in range(self.alpha - 1):
            K = K @ Kbase
        propagation = K + B
        if streamline_diffusion:
            S = on(disc.streamline_diffusion_matrix(self.gamma, h=h))
            if self.bc == "dirichlet":
                S = _decouple_rows_cols(S, bmask, 0.0)
            propagation = propagation + S
        G_dt = spdiag(M.diagonal()) + propagation * (dt / self.c)

        kappa = torch.tensor(self.spatial_kappa, dtype=torch.float64, device=dev)
        x0 = self.initial_spde.discretize(kappa, solver=SolverSpec(kind="dense"))
        Q_s = self.spatial_spde.precision(kappa)

        # Σ⁻¹ = M⁻ᵀ β⁻ᵀ Q_s β⁻¹ M⁻¹ with β = √dt·(τ/√c)·I and diagonal M
        beta_inv = 1.0 / (np.sqrt(dt) * self.tau / np.sqrt(self.c))
        D = spdiag(beta_inv / M.diagonal())
        Sigma_inv = D @ Q_s @ D

        if self.bc == "dirichlet":
            # soft constraints: G rows→[0…1…0], Σ⁻¹ decoupled with noise⁻² diag
            G_dt = _zero_rows(G_dt, bmask, 1.0)
            Sigma_inv = _decouple_rows_cols(Sigma_inv, bmask, self.constraint_noise ** (-2.0))

        Md = spdiag(M.diagonal())
        GtS = G_dt.T @ Sigma_inv
        F_inv = GtS @ G_dt
        AtFA = (Md @ Sigma_inv) @ Md
        F_inv_A = GtS @ Md

        mid = F_inv + AtFA
        diag_blocks = [x0.Q + AtFA] + [mid] * (Nt - 2) + [F_inv]
        off_blocks = [F_inv_A * -1.0] * (Nt - 1)
        Q_joint = sp_block_tridiag(diag_blocks, off_blocks).symmetrize()

        # per-step means μᵢ = G⁻¹(M μᵢ₋₁), μ₀ = mean(x₀) (zero here); only the
        # Dirichlet inhomogeneity can make them nonzero, so the homogeneous
        # case skips the steps
        bvals = np.broadcast_to(
            np.asarray(boundary_values, dtype=np.float64).ravel(),
            (len(bnodes),) if bnodes is not None else (0,),
        )
        mu0_nonzero = bool(torch.any(x0.mean != 0.0))
        if mu0_nonzero or (bnodes is not None and np.any(bvals != 0.0)):
            mean = _ssm_means(G_dt, M.diagonal(), x0.mean, Nt, bnodes, bvals, DENSE_AUTO_MAX) + float(mean_offset)
        else:
            mean = torch.full((Ns * Nt,), float(mean_offset), dtype=Q_joint.dtype, device=dev)
        return mean, Q_joint


def kronecker_product_spatiotemporal_model(
    Q_t: SparseMatrix, Q_s: SparseMatrix, disc: FEMDiscretization, solver: SolverSpec = SolverSpec()
) -> SpatiotemporalGMRF:
    """Q_st = Q_t ⊗ Q_s (time ⊗ space, space fastest, R-INLA's convention)."""
    Q = sp_kron(Q_t, Q_s)
    g = GMRF.from_precision(torch.zeros(Q.shape[0], dtype=Q.dtype, device=Q.device), Q, solver)
    return SpatiotemporalGMRF(g, Q_t.shape[0], disc)


def product_matern(
    temporal_spde_smoothness: int,
    kappa_t,
    N_t: int,
    spatial_spde: MaternSPDE,
    kappa_s,
    solver: SolverSpec = SolverSpec(),
) -> SpatiotemporalGMRF:
    """Temporal Matérn on an inflated 1D grid (10% padding at each end) ×
    spatial Matérn: the interior slice of the temporal precision, Kronecker
    with the spatial one. κ_t and κ_s are scalars or (B,) tensors."""
    offset = N_t // 10
    n_temp = N_t + 2 * offset
    tdisc = FEMDiscretization(interval_mesh(0.0, float(n_temp - 1), n_temp))
    tspde = MaternSPDE(tdisc, smoothness=temporal_spde_smoothness)
    # interior slice (dense is fine: the temporal dimension is small)
    Qt = tspde.precision(kappa_t).todense()[..., offset : offset + N_t, offset : offset + N_t]
    mask = (Qt.reshape(-1, N_t, N_t) != 0).any(0).cpu().numpy()
    pat = SparsePattern.from_dense_mask(mask)
    rows = torch.tensor(pat.rows, dtype=torch.long, device=Qt.device)
    cols = torch.tensor(pat.cols, dtype=torch.long, device=Qt.device)
    Q_t = SparseMatrix(Qt[..., rows, cols], pat)
    Q_s = spatial_spde.precision(kappa_s)
    return kronecker_product_spatiotemporal_model(Q_t, Q_s, spatial_spde.disc, solver)
