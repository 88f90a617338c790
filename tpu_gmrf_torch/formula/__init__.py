"""The formula interface: R-style model formulas to a latent model, a design
matrix and an observation model (counterpart of ``tpu_gmrf.formula``; a
subpackage whose names the top level does not bind, as in the reference)."""

from .terms import (
    AR,
    AR1,
    BYM2,
    Besag,
    Col,
    Fixed,
    IID,
    Intercept,
    Matern,
    RandomWalk,
    RW1,
    RW2,
    Separable,
    Term,
)
from .build import build_formula_components, FormulaComponents, predict_cols, sp_hstack

__all__ = [
    "AR",
    "AR1",
    "BYM2",
    "Besag",
    "Col",
    "Fixed",
    "IID",
    "Intercept",
    "Matern",
    "RandomWalk",
    "RW1",
    "RW2",
    "Separable",
    "Term",
    "build_formula_components",
    "FormulaComponents",
    "predict_cols",
    "sp_hstack",
]
