from .gaussian_approximation import GAOptions, NewtonMode, gaussian_approximation
from .joint import joint_gmrf, sp_bmat
from .linear_condition import linear_condition
from .marginal import laplace_marginal, marginal_loglikelihood
from .marginals import conditional_predictive_ordinates, linear_predictor_marginals, waic

__all__ = ["GAOptions", "NewtonMode", "gaussian_approximation", "laplace_marginal", "marginal_loglikelihood",
           "linear_condition", "joint_gmrf", "sp_bmat", "linear_predictor_marginals", "waic",
           "conditional_predictive_ordinates"]
