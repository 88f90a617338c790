from .gaussian_approximation import GAOptions, NewtonMode, gaussian_approximation
from .marginal import laplace_marginal, marginal_loglikelihood

__all__ = ["GAOptions", "NewtonMode", "gaussian_approximation", "laplace_marginal", "marginal_loglikelihood"]
