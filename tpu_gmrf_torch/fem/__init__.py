"""Finite-element SPDE models: triangle meshes, P1 assembly, Matérn SPDE."""

from .discretization import FEMDiscretization, assemble_coo
from .mesh import TriangleMesh, auto_mesh_size, generate_mesh
from .spde import MaternModel, MaternSPDE, range_to_kappa, smoothness_to_nu

__all__ = [
    "TriangleMesh",
    "generate_mesh",
    "auto_mesh_size",
    "FEMDiscretization",
    "assemble_coo",
    "MaternSPDE",
    "MaternModel",
    "range_to_kappa",
    "smoothness_to_nu",
]
