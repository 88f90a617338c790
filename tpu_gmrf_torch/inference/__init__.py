from .gaussian_approximation import GAOptions, NewtonMode, gaussian_approximation
from .linear_condition import linear_condition
from .marginal import laplace_marginal, marginal_loglikelihood

__all__ = ["GAOptions", "NewtonMode", "gaussian_approximation", "laplace_marginal", "marginal_loglikelihood",
           "linear_condition"]
