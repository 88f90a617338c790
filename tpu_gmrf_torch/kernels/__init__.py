"""Hand-written Hopper kernels of the port, with wrappers and plain versions.

K1 ``tridiag_factor``, K2 ``tridiag_solve``, K3 ``tridiag_selinv`` and K4
``csr_spmv``. Sources are in ``tpu_gmrf_torch/csrc/``; ``build`` compiles
them with nvcc at first use on a CUDA tensor.
"""

from .spmv import csr_spmv, csr_spmv_plain
from .tridiag import (
    SOLVE_BOTH,
    SOLVE_L,
    SOLVE_LT,
    tridiag_factor,
    tridiag_factor_plain,
    tridiag_selinv,
    tridiag_selinv_plain,
    tridiag_solve,
    tridiag_solve_plain,
)

__all__ = [
    "KERNELS", "reset_launches", "launches",
    "csr_spmv", "csr_spmv_plain",
    "tridiag_factor", "tridiag_factor_plain",
    "tridiag_solve", "tridiag_solve_plain",
    "tridiag_selinv", "tridiag_selinv_plain",
    "SOLVE_L", "SOLVE_LT", "SOLVE_BOTH",
]

KERNELS = {
    "tridiag_factor": tridiag_factor,
    "tridiag_solve": tridiag_solve,
    "tridiag_selinv": tridiag_selinv,
    "csr_spmv": csr_spmv,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
