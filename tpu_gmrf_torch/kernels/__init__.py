"""Hand-written Hopper kernels of the port, with wrappers and plain versions.

K1 ``tridiag_factor``, K2 ``tridiag_solve``, K3 ``tridiag_selinv``, K4
``csr_spmv``, K5 ``gather_segsum`` (and its second entry ``fct_init``), K6 ``sn_panel``, K7 ``sn_trsv``, K8
``sn_takahashi`` (and its first entry ``sn_takahashi_prep``), K9 ``dense_chol``, K10 ``dense_trsv`` (and its second
entry ``dense_selinv``), K11 ``bt_factor``,
K12 ``bt_trsv``, K13 ``bt_matvec`` (and its second entry ``bt_sqrt``), K14
``bsr_spmm``, K15 ``bsr_outer``, K16 ``kl_columns``, K17 ``block_inv`` and
K18 ``spike_reduced``, and the tangents of the selected inverse K19
``tridiag_selinv_tangent``, K20 ``sn_panel_tangent``, K21
``sn_takahashi_tangent`` and K22 ``bt_factor_tangent``, and the factorizations'
adjoints (the derivative of a sample, a triangular solve or L·z) K23
``tridiag_factor_adjoint``, K24 ``bt_factor_adjoint`` and K25
``sn_panel_adjoint``; K7 has a second mode, ``sn_multiply`` (with its
transpose), K13's second entry ``bt_sqrt`` a transpose mode, and K11 and K12
a block entry each, ``bt_factor_blocks`` and ``bt_trsv_blocks`` (the SPIKE
solve's chunk elimination).
Sources are in ``tpu_gmrf_torch/csrc/``; ``build`` compiles them with nvcc
at first use on a CUDA tensor. ``hot_matvec`` picks the repeated-multiply
formulation (K4, K13 or K14) for a fixed sparse matrix.
"""

from .banded import (
    BandedTables,
    bt_factor,
    bt_factor_adjoint,
    bt_factor_adjoint_plain,
    bt_factor_blocks,
    bt_factor_blocks_plain,
    bt_factor_plain,
    bt_factor_tangent,
    bt_factor_tangent_plain,
    bt_matvec,
    bt_matvec_plain,
    bt_sqrt,
    bt_sqrt_plain,
    bt_sqrt_t_plain,
    bt_trsv,
    bt_trsv_blocks,
    bt_trsv_blocks_plain,
    bt_trsv_plain,
)
from .block_inv import BlockSets, block_inv, block_inv_plain, block_inv_smem_max
from .bsr_spmv import (
    BSRMatrix,
    best_block_size,
    bsr_from_sparse,
    bsr_outer,
    bsr_outer_plain,
    bsr_spmm,
    bsr_spmm_plain,
    bsr_spmv,
)
from .dense import (
    DenseTables,
    dense_chol,
    dense_chol_plain,
    dense_selinv,
    dense_selinv_plain,
    dense_trsv,
    dense_trsv_plain,
)
from .segsum import InitPlan, SegPlan, fct_init, fct_init_plain, gather_segsum, gather_segsum_plain
from .hot import hot_matvec
from .kl import kl_columns, kl_columns_plain, kl_path
from .spike import spike_reduced, spike_reduced_plain
from .spmv import csr_spmv, csr_spmv_plain, spmv_path
from .supernodal import (
    BACKWARD,
    FORWARD,
    MULTIPLY,
    MULTIPLY_T,
    sn_multiply,
    sn_multiply_plain,
    sn_panel,
    sn_panel_adjoint,
    sn_panel_adjoint_plain,
    sn_panel_plain,
    sn_takahashi,
    sn_takahashi_plain,
    sn_takahashi_prep,
    sn_panel_tangent,
    sn_panel_tangent_plain,
    sn_takahashi_prep_plain,
    sn_takahashi_sweep_plain,
    sn_takahashi_tangent,
    sn_takahashi_tangent_plain,
    sn_trsv,
    sn_trsv_plain,
)
from .tridiag import (
    SOLVE_BOTH,
    SOLVE_L,
    SOLVE_LT,
    scan_launch,
    tridiag_factor,
    tridiag_factor_adjoint,
    tridiag_factor_adjoint_plain,
    tridiag_factor_plain,
    tridiag_selinv,
    tridiag_selinv_plain,
    tridiag_selinv_tangent,
    tridiag_selinv_tangent_plain,
    tridiag_solve,
    tridiag_solve_plain,
)

__all__ = [
    "KERNELS", "reset_launches", "launches",
    "csr_spmv", "csr_spmv_plain",
    "tridiag_factor", "tridiag_factor_plain",
    "tridiag_solve", "tridiag_solve_plain",
    "tridiag_selinv", "tridiag_selinv_plain", "tridiag_selinv_tangent", "tridiag_selinv_tangent_plain",
    "SOLVE_L", "SOLVE_LT", "SOLVE_BOTH",
    "SegPlan", "gather_segsum", "gather_segsum_plain", "InitPlan", "fct_init", "fct_init_plain",
    "sn_panel", "sn_panel_plain", "sn_trsv", "sn_trsv_plain", "sn_takahashi", "sn_takahashi_plain",
    "sn_takahashi_prep", "sn_takahashi_prep_plain", "sn_takahashi_sweep_plain",
    "FORWARD", "BACKWARD",
    "DenseTables", "dense_chol", "dense_chol_plain", "dense_trsv", "dense_trsv_plain", "dense_selinv",
    "dense_selinv_plain",
    "BandedTables", "bt_factor", "bt_factor_plain", "bt_trsv", "bt_trsv_plain",
    "bt_matvec", "bt_matvec_plain", "bt_sqrt", "bt_sqrt_plain",
    "BSRMatrix", "best_block_size", "bsr_from_sparse", "bsr_spmv", "bsr_spmm", "bsr_spmm_plain",
    "bsr_outer", "bsr_outer_plain", "hot_matvec",
    "MULTIPLY", "sn_multiply", "sn_multiply_plain", "spmv_path", "scan_launch",
    "kl_columns", "kl_columns_plain", "kl_path", "BlockSets", "block_inv", "block_inv_plain", "block_inv_smem_max",
    "bt_factor_blocks", "bt_factor_blocks_plain", "bt_trsv_blocks", "bt_trsv_blocks_plain",
    "spike_reduced", "spike_reduced_plain",
    "sn_panel_tangent", "sn_panel_tangent_plain", "sn_takahashi_tangent", "sn_takahashi_tangent_plain",
    "bt_factor_tangent", "bt_factor_tangent_plain",
    "tridiag_factor_adjoint", "tridiag_factor_adjoint_plain", "bt_factor_adjoint", "bt_factor_adjoint_plain",
    "bt_sqrt_t_plain", "sn_panel_adjoint", "sn_panel_adjoint_plain", "MULTIPLY_T",
]

KERNELS = {
    "tridiag_factor": tridiag_factor,
    "tridiag_solve": tridiag_solve,
    "tridiag_selinv": tridiag_selinv,
    "csr_spmv": csr_spmv,
    "gather_segsum": gather_segsum,
    "fct_init": fct_init,
    "sn_panel": sn_panel,
    "sn_trsv": sn_trsv,
    "sn_multiply": sn_multiply,
    "sn_takahashi_prep": sn_takahashi_prep,
    "sn_takahashi": sn_takahashi,
    "dense_chol": dense_chol,
    "dense_trsv": dense_trsv,
    "dense_selinv": dense_selinv,
    "bt_factor": bt_factor,
    "bt_trsv": bt_trsv,
    "bt_matvec": bt_matvec,
    "bt_sqrt": bt_sqrt,
    "bsr_spmm": bsr_spmm,
    "bsr_outer": bsr_outer,
    "kl_columns": kl_columns,
    "block_inv": block_inv,
    "bt_factor_blocks": bt_factor_blocks,
    "bt_trsv_blocks": bt_trsv_blocks,
    "spike_reduced": spike_reduced,
    "tridiag_selinv_tangent": tridiag_selinv_tangent,
    "sn_panel_tangent": sn_panel_tangent,
    "sn_takahashi_tangent": sn_takahashi_tangent,
    "bt_factor_tangent": bt_factor_tangent,
    "tridiag_factor_adjoint": tridiag_factor_adjoint,
    "bt_factor_adjoint": bt_factor_adjoint,
    "sn_panel_adjoint": sn_panel_adjoint,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
