"""Block-tridiagonal solves with the time axis split into chunks (SPIKE).

Counterpart of ``tpu_gmrf.parallel``: the chunks go over the ranks of a
``torch.distributed`` device mesh, one per rank, or run as a batch axis in
one process.
"""

from .pbtridiag import pbtridiag_logdet, pbtridiag_solve, sharded_block_tridiag_solver

__all__ = [
    "pbtridiag_solve",
    "pbtridiag_logdet",
    "sharded_block_tridiag_solver",
]
