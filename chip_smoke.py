#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_gmrf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. the device: needs CUDA; prints the card's name and power limit;
2. the build: compiles the kernels K1-K18 (K5 with its second entry,
   fct_init; K7 with its multiply mode; K10 with its second entry,
   dense_selinv; K11 and K12 with their block entries, bt_factor_blocks and
   bt_trsv_blocks; K13 with its second entry, bt_sqrt) from
   tpu_gmrf_torch/csrc with nvcc (one nvcc per source, in parallel) and
   the host symbolic core with g++;
3. K1-K4 against their plain PyTorch versions on the card, at the flagship
   shapes (B=256 chains, n=500), in float64 and float32; then beyond shared
   memory: K4 at n=14058 (B=1 and 8, values shared and per chain, with the
   quadratic form) also against CSR ``torch.sparse.mm``, and K1-K3 at
   n=20000, B=4;
3b. K5-K8 against their plain versions on the card at the spatial shapes
   (Matérn α=2 on the 63×63 grid, n=5741, B=4 chains: the prior at τ=1,
   range=0.25 and the posterior with a random positive diagonal H), in
   float64 and float32, over the whole supernodal schedule;
3c. K9-K10 and dense_selinv (the dense backend, g=16 posterior, n=450,
   B=8) and K11-K12 (the banded backend, n=5741, B=4, s=512, K=12; K11 also
   at s=496 through the plan's block=8, and through its rescue: one chain
   with an indefinite block, equal boosts required; K12 with its time split
   into the inversion of the blocks and the sweeps, at k = 1, 8, 9 and 65
   right-hand sides, and in modes 0, 1 and 2 on the s=512, the s=496 and
   the forced-rescue factors) against their plain versions and against the
   library call, where one computes the same function or its blocks (K11:
   cholesky_ex of the K blocks and solve_triangular for the M_k; K12:
   solve_triangular both ways on each block), in float64 and float32;
3d. the multiply kernels against their plain versions, in float64 and
   float32: K13 bt_matvec and K14 bsr_spmm at the bench_spmv operator
   (Matérn α=2 on 100x100 points, n=14058, 8 vectors) and at the 316x316
   grid precision (n=99856), K14 at each block size forward and
   transposed, K15 bsr_outer, the BSR gradient against the plain version's
   autograd, K4 at those sizes, bt_sqrt on the n=5741 banded factor and K7's
   multiply mode on the n=14058 supernodal factor; K13 with the bytes it
   moves and its rate, and at its edges (one block; blocks of 91 and 96 rows
   with 9 vectors; per-chain blocks), bt_sqrt at phase 14's shape;
3e. K16 kl_columns on the column buckets of example 09's KL factor at
   n=10,000 (rho = 3 and 6) and on one bucket beyond shared memory, K17
   block_inv on the n=1000 graphical lasso's cliques and separators (and one
   set of 200, beyond shared memory), rectangular K4 on a 500 x 14058
   selection matrix and its transpose, against their plain versions and the
   library yardsticks, in float64 and float32;
3f. K11's and K12's block entries and K18 spike_reduced on the arguments the
   SPIKE solve gives them, at phase 17's shape (4 chunks of 31 interior
   blocks of 450, 901 right-hand sides; the 4-block interface system) and at
   example 12's, against their plain versions and the library yardstick
   (cholesky_ex + solve_triangular on the same blocks), in float32 and
   float64; K12's block entry at k = 1 (the gradient's re-solve), 8, 9, 64
   and 901 at phase 17's shape, and the three kernels at the tile edges
   (K11's block entry at blocks of 5, 64 and 65, K = 1 and 2, and with an
   indefinite block in one of three chains, whose logdet alone is NaN; K12's
   and K18 at blocks of 64 and 65, P = 1 and 2, k = 1, 3, 64, 65);
4. the flagship slice: batched value and θ-gradient of the Laplace marginal
   of an AR1 + Poisson model (256 chains, n=500) through the kernels, in
   float32, checked against the plain path in float64 (the same code on CPU
   tensors) and against the kernel path in float64;
5. a few HMC steps over the 256 chains;
6. GMRF statistics at n=14058 (g=100), B=1: factorize, logdet, selinv_diag,
   solve and sample, each against its plain version on the card;
7. the spatial slice: batched value and θ-gradient of the Laplace marginal
   of the Matérn + Poisson model (n=5741, 4 chains) on the supernodal
   backend, float32 on the kernels, checked against the float32 and the
   float64 plain paths on CPU tensors and the float64 kernel path; the
   Newton iterations are counted (``--profile`` adds a
   torch.profiler trace of one value+grad: device busy time and idle share);
8. 3 HMC steps x 8 leapfrogs over the 4 chains, in float64;
9. the flagship run_nuts (bench.py:445-504): 256 chains, n=500, float32,
   max_depth 8, with the draws cut (NUTS_FLAGSHIP_DRAWS);
10. the spatial run_nuts at g=16 (bench.py:308-312): n=450, 8 chains,
   max_depth 6, 15 Newton iterations, supernodal prior, the default inner
   solver (auto -> dense, K9/K10), float64;
11. the spatial run_nuts at n=5741 (bench.py:315-332, uncut): 4 chains,
   4 warmup + 4 samples, max_depth 3, 10 Newton iterations, supernodal
   prior, the default inner solver (auto -> banded, K11/K12), float64; one
   value+grad on the banded inner solver against the supernodal one, and
   one NUTS transition with fixed draws on the kernels against the plain
   path on CPU tensors;
12. the multiply path, bench_spmv as the reference wrote it (bench.py:507):
   n=14058, 8 vectors, float32, 64 chained normalized multiplies per
   timing, through K4, K13, K14 and whatever hot_matvec picks; one gradient
   through the BSR operator (K15); each multiply's device time from a trace
   (K13: its three kernels) and K13's bytes and rate;
13. the CG path at n=99856 (the 316x316 grid precision): factorize with
   SolverSpec(kind="cg"), 8 right-hand sides, once per formulation and once
   through hot_matvec, float64 and float32; GMRF.from_information;
13b. CG on the Matérn operator at n=14058, float64: Jacobi, and the full
   Cholesky preconditioner, against the supernodal solve;
14. RBMC variances: rbmc_var at n=14058 (1000 samples) against selinv_diag,
   block_rbmc_var at n=5741; N(0, Q) draws through CholeskySqrtMap on the
   banded and the supernodal factor;
15. the KL path (examples/09_kl_approximation.py): approximate_gmrf_kl at
   g=30 (n=900, auto -> dense) with the example's checks, a sum-to-zero
   ConstrainedGMRF, linear_condition on both; then g=100 (n=10,000, auto ->
   supernodal) with 50 observations; against the plain path, float64;
16. the graphical lasso (examples/10_graphical_lasso.py): n=200 with the
   example's checks for lambda and the restricted Lambda, then n=1000,
   m=20,000 and the logpdf of 100 held-out samples; against the plain
   versions, float64;
17. the SPIKE path (tpu_gmrf/parallel/pbtridiag.py): the space-time
   precision Q_t ⊗ Q_s (AR1 over Nt=128, ρ=0.9; Matérn α=2 at g=16, ns=450)
   in P=4 chunks on one card, f64: x, logdet and the gradient of bᵀQ⁻¹b with
   respect to diag, sub and b, the solve's and the gradient's time split by
   kernel, against the supernodal solve and logdet of the assembled sparse Q (residual by SymmetricBlockTridiagonalMap) and the
   plain path on CPU tensors; example 12 part 3 with its own limits; the
   public pbtridiag_solve / pbtridiag_logdet on a one-rank NCCL DeviceMesh
   and supernodal_factorize(mesh=) on it at n=5741;
18. fault 3.1: d/dτ through the direct solves on the card (a sum-to-zero
   ConstrainedGMRF's logpdf on every direct backend; linear_condition's mean
   at the KL n=900 setup), against the plain path and a difference, f64.

Every kernel's launch counter is zeroed just before each main path (phases
4-5, the flagship; 7-8, the spatial slice; 9, 10 and 11) and read after
it, and so before and after each of the paths 12, 13, 13b, 14, 15, 16, 17 and 18;
a kernel of the path that was never launched fails the run. Each phase's
seconds are printed when the next begins. The line before the last is one
JSON object with the kernels' launches, errors, times and bounds; the last
line is the result object. Needs no network and imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N = 500  # AR1 length, as the flagship workload
CHAINS = 256
GA_MAX_ITER = 25
HMC_STEPS, LEAPFROG = 5, 8
STEP_SIZE = 0.05
REPS = 20  # timed launches per kernel

# Normwise tolerances (max |kernel - plain| / max |plain|) of the kernel checks.
# float64: both sides are exact up to rounding order. float32: the kernels
# run the sequential recurrences while the plain versions run doubling scans
# (normalized Möbius products for the pivots); over n=500 steps the rounding
# of the two differs by up to ~n·eps.
KERNEL_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# The slice: the float64 kernel path against the float64 plain path differs
# only by rounding order (rel 1e-8 value, 1e-6 gradient, the Newton stop can
# move by one iteration). The float32 kernel path against the float64
# plain path: float32 rounding inside Newton and the logdets.
SLICE_TOL = {"f64_value": 1e-8, "f64_grad": 1e-6, "f32_value": 1e-4, "f32_grad": 5e-3}
# The spatial slice: float64 as above. float32: the Matérn α=2 prior at
# n=5741 has a scaled condition far above 1/eps(f32), and the f32 Takahashi
# Σ it feeds the θ-gradient (tr(Σ dQ/dθ), a difference of two traces) is
# off by up to 3% on the diagonal whatever runs it. So the f32 slice cannot
# meet SLICE_TOL's f32 bounds, and no f32 path does: on the H100 the f32
# kernel path reads value 2.39e-4 and gradient 0.154 from the f64 plain
# path, and the f32 plain path on CPU tensors, on the same inputs, 2.21e-4
# and 0.156 (the gap comes from the f32 inputs, common to both paths). The
# f32 bounds sit just above those readings. The "f32p" bounds hold the f32
# kernel path against the f32 plain path (the same code on CPU tensors,
# the same inputs), which read 8.0e-5 and 8.7e-3; the kernels' exactness
# is held by the float64 comparison.
SP_SLICE_TOL = {"f64_value": 1e-8, "f64_grad": 1e-6, "f32_value": 3e-4, "f32_grad": 0.18,
                "f32p_value": 1.2e-4, "f32p_grad": 1.2e-2}

# The spatial slice: the reference's bench_spatial_poisson_nuts_5741
# configuration (bench.py:315-332): 63x63 grid, smoothness 1, 4 chains,
# GAOptions(max_iter=10) with the supernodal inner solver; HMC in place of NUTS.
SP_GRID, SP_CHAINS, SP_GA_ITER = 63, 4, 10
# HMC of the spatial slice runs in float64: the f32 θ-gradient of this
# prior is off by up to tens of percent (see SP_SLICE_TOL), and on the H100
# the f64 value+grad costs little more than the f32 one.
SP_HMC_STEPS, SP_STEP_SIZE = 3, 0.01
STATS_GRID = 100  # bench_supernodal_factorize_selinv's larger size, n=14058
SN_REPS = 5  # timed repetitions of a whole supernodal schedule

# Normwise tolerances of K5-K8 against their plain versions. K6 is held
# against the plain factorization; K7 and K8 against their plain versions on
# the same (kernel) factor, so each check sees one kernel's rounding.
# float64: both sides are exact up to rounding order. float32: the schedule
# is identical, only summation orders differ (inside the panel Cholesky, the
# ELL rows and the products); but the Matérn α=2 prior at n=5741 has a
# scaled condition far above 1/eps(f32), which amplifies that rounding:
# on the H100, factor values 1.2e-4 (n=5741) and 6.2e-4 (n=14058) normwise,
# Σ 1.8e-4 and 1.2e-3, solves below 1e-5. K5 sums at most a few dozen
# terms, and fct_init is a few products per entry: 1e-5.
SN_TOL = {
    torch.float64: {"gather_segsum": 1e-10, "fct_init": 1e-10, "sn_panel": 1e-10, "logdet": 1e-10,
                    "sn_trsv": 1e-10, "sn_takahashi": 1e-10},
    torch.float32: {"gather_segsum": 1e-5, "fct_init": 1e-5, "sn_panel": 1e-3, "logdet": 1e-4,
                    "sn_trsv": 1e-4, "sn_takahashi": 5e-3},
}
# K9-K12 against their plain versions on the same inputs (phase 3c).
# float64: exact up to rounding order, held to 1e-12. float32: the limits
# are set from the first readings on the H100 (K9 factor 1.5e-6, K10
# 3.2e-7, K11 factor 1.2e-5, K12 7.7e-7), about ten times above them.
# K10's second entry dense_selinv (Σ at Q's pattern) read 2.5e-7 in f32.
SN_TOL[torch.float64].update(dense_chol=1e-12, dense_trsv=1e-12, dense_selinv=1e-12, bt_factor=1e-12,
                             bt_trsv=1e-12)
SN_TOL[torch.float32].update(dense_chol=2e-5, dense_trsv=5e-6, dense_selinv=3e-6, bt_factor=1e-4, bt_trsv=1e-5)
# K13-K15, bt_sqrt, K7's multiply mode and K4 at the large shapes, against
# their plain versions on the same inputs: float64 sums of a few hundred
# terms in another order, 1e-12; float32 1e-5 (the first readings on the
# H100 were at most 4.4e-6, the supernodal product's). "identity" holds
# L (L⁻¹ z) = z, which carries the factor's conditioning.
SN_TOL[torch.float64].update(csr_spmv=1e-12, bt_matvec=1e-12, bt_sqrt=1e-12, bsr_spmm=1e-12, bsr_outer=1e-12,
                             sn_multiply=1e-10, tridiag=1e-10, identity=1e-9)
SN_TOL[torch.float32].update(csr_spmv=1e-5, bt_matvec=1e-5, bt_sqrt=1e-5, bsr_spmm=1e-5, bsr_outer=1e-5,
                             sn_multiply=1e-4, tridiag=1e-4, identity=1e-3)
DN_GRID, DN_CHAINS = 16, 8  # the dense backend's shape: the g=16 posterior, as phase 10

# Bounds (the least time the card could take): the larger of the bytes a
# function must move over HBM's rate and its operations over the card's
# peak rate for their type, H100 SXM data sheet: 3.35 TB/s; 67 TFLOP/s
# float32 (no tensor-core f32 product is exact in f32) and 67 TFLOP/s
# float64 (the FP64 tensor cores, DMMA; 34 TFLOP/s without them). The
# bound is the card's, whether or not a kernel uses those units.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

# Phases 9-11: run_nuts as the reference's benches (bench.py) set it up.
# The flagship's draws are cut from 100 + 100 to fit the time limit; the
# spatial runs are uncut.
NUTS_FLAGSHIP = dict(warmup=10, samples=10, depth=8)
NUTS_G16 = dict(grid=16, chains=8, warmup=25, samples=25, depth=6, ga_iter=15)
NUTS_5741 = dict(chains=4, warmup=4, samples=4, depth=3, ga_iter=10)
# Phase 11's cross-checks: the banded inner solver against the supernodal
# one (the same Laplace fixed point, float64: 1e-8 value, 1e-6 gradient) and
# one NUTS transition with fixed draws on the kernels against the plain
# path (equal depth and leaves; positions within 1e-6).
NUTS_TOL = {"value": 1e-8, "grad": 1e-6, "position": 1e-6}

SOURCES = {
    "tridiag_factor": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/prefix.py:53"),
    "tridiag_solve": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/prefix.py:33"),
    "tridiag_selinv": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/tridiag.py:70"),
    "csr_spmv": ("tpu_gmrf_torch/csrc/spmv.cu", "tpu_gmrf/sparse/matrix.py:58"),
    "gather_segsum": ("tpu_gmrf_torch/csrc/segsum.cu", "tpu_gmrf/sparse/matrix.py:173"),
    "fct_init": ("tpu_gmrf_torch/csrc/segsum.cu", "tpu_gmrf/solvers/supernodal.py:931"),
    "sn_panel": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:907"),
    "sn_trsv": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1171"),
    "sn_takahashi": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1000"),
    "dense_chol": ("tpu_gmrf_torch/csrc/dense.cu", "tpu_gmrf/solvers/dense.py:102"),
    "dense_trsv": ("tpu_gmrf_torch/csrc/dense.cu", "tpu_gmrf/solvers/dense.py:47"),
    "dense_selinv": ("tpu_gmrf_torch/csrc/dense.cu", "tpu_gmrf/solvers/dense.py:74"),
    "bt_factor": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:354"),
    "bt_trsv": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:145"),
    "sn_multiply": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1287"),
    "bt_matvec": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:297"),
    "bt_sqrt": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:272"),
    "bsr_spmm": ("tpu_gmrf_torch/csrc/bsr.cu", "tpu_gmrf/kernels/bsr_spmv.py:182"),
    "bsr_outer": ("tpu_gmrf_torch/csrc/bsr.cu", "tpu_gmrf/kernels/bsr_spmv.py:215"),
    "kl_columns": ("tpu_gmrf_torch/csrc/kl.cu", "tpu_gmrf/kl_cholesky.py:116"),
    "block_inv": ("tpu_gmrf_torch/csrc/block_inv.cu", "tpu_gmrf/graphical_lasso.py:150"),
    "bt_factor_blocks": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/parallel/pbtridiag.py:53"),
    "bt_trsv_blocks": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/parallel/pbtridiag.py:76"),
    "spike_reduced": ("tpu_gmrf_torch/csrc/spike.cu", "tpu_gmrf/parallel/pbtridiag.py:100"),
}
FLAGSHIP_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "csr_spmv", "gather_segsum")
SPATIAL_KERNELS = ("csr_spmv", "gather_segsum", "fct_init", "sn_panel", "sn_trsv", "sn_takahashi")
# The NUTS paths factor and differentiate the supernodal prior (K5, K6, K8)
# but never solve with it, so K7 is not on them; the inner solver is K9/K10
# at g=16 and K11/K12 at n=5741.
SPATIAL_NUTS_KERNELS = ("csr_spmv", "gather_segsum", "fct_init", "sn_panel", "sn_takahashi")
NUTS_G16_KERNELS = SPATIAL_NUTS_KERNELS + ("dense_chol", "dense_trsv")
NUTS_5741_KERNELS = SPATIAL_NUTS_KERNELS + ("bt_factor", "bt_trsv")
# The matrix-free paths (phases 12-14).
MULTIPLY_KERNELS = ("csr_spmv", "bt_matvec", "bsr_spmm", "bsr_outer")
# the device kernels of one multiply, by name in a trace (K13: its gather, its units and its scatter)
MULTIPLY_KERNEL_NAMES = {"csr_spmv": ("csr_spmv",), "bt_matvec": ("bt_rows_in", "bt_matvec_kernel", "bt_rows_out"),
                         "bsr_spmm": ("bsr_spmm_kernel",)}
CG_KERNELS = ("csr_spmv", "bt_matvec", "bsr_spmm")
# phase 13b multiplies by whatever hot_matvec picks (added to the list there) and preconditions with the supernodal solve
CG_MATERN_KERNELS = ("fct_init", "sn_panel", "sn_trsv", "gather_segsum")
RBMC_KERNELS = ("csr_spmv", "sn_trsv", "gather_segsum", "sn_multiply", "bt_factor", "bt_sqrt")
# Phase 15: K16 per bucket, K5's SpGEMM L Lᵀ, K4 for the rectangular observation matrix, the dense backend
# at n=900 and the supernodal one at n=10,000 (auto). Phase 16: K17 and K5's signed sums, the dense backend
# (n ≤ 1000, auto) and K4's quadratic form in logpdf.
KL_KERNELS = ("kl_columns", "gather_segsum", "csr_spmv", "dense_chol", "dense_trsv", "fct_init", "sn_panel",
              "sn_trsv", "sn_takahashi")
GLASSO_KERNELS = ("block_inv", "gather_segsum", "dense_chol", "csr_spmv")

# Phases 12-14. bench_spmv: 64 chained multiplies, 5 timed repetitions, 8
# vectors. The CG path: 316x316 grid, 8 right-hand sides; float32 cannot
# reach the default cg_tol = 1e-8 (its rounding is 6e-8), so the float32
# runs ask for 1e-5. The formulations' solutions agree within 100 tol
# (each stops at its own residual below tol; κ = 25 here).
SPMV_CHAIN, SPMV_REPS, SPMV_VECS = 64, 5, 8
CG_GRID, CG_RHS = 316, 8
CG_TOL = {torch.float64: 1e-8, torch.float32: 1e-5}
# RBMC: S = 1000 samples at n = 14058; block RBMC at n = 5741 with its
# default S = 100. Both add the sample variance of S Gaussian draws to an
# exact part; a sample variance has relative standard deviation
# σ_S = sqrt(2 / (S - 1)) (0.045 at S = 1000, 0.142 at S = 100), and on the
# Matérn α=2 prior at range 0.25 nearly all of a node's variance is in that
# sampled part. Held: 6 σ_S at every node (the largest of 14058 skewed
# errors) and 1.5 σ_S on average (the expected mean |error| is 0.8 σ_S; the
# nodes share the S draws, so their mean does not settle like 1/sqrt(n)).
# The reference's test takes rtol 0.15 at S = 4000 on n = 20: 6.7 σ_S.
RBMC_SAMPLES, BLOCK_RBMC_SAMPLES = 1000, 100

# Phases 3e, 15, 16: example 09 (examples/09_kl_approximation.py: Matérn-3/2, ℓ = 0.3, on a g x g grid of the
# unit square, ρ = 3, jitter 1e-8, 12 probe columns, 5 observations at Q_ε = 1e4) at g = 30 and, as
# large as the reference's O(n²) host ordering allows here, g = 100 (n = 10,000) with 50 observations; K16
# also at ρ = 6. Example 10 (examples/10_graphical_lasso.py: a sparse diagonally dominant truth, λ = 0.03)
# at n = 200, m = 4000 and at n = 1000, m = 20,000, density 0.004 (its O(n²) chordal cover bounds n).
KL_GRID_SMALL, KL_GRID, KL_RHO, KL_RHO_WIDE, KL_JITTER, KL_ELL, KL_OBS = 30, 100, 3.0, 6.0, 1e-8, 0.3, 50
GL_SMALL = dict(n=200, m=4000, density=0.02, lam=0.03)
GL = dict(n=1000, m=20000, density=0.004, lam=0.03, held_out=100)
# K16 and K17 against their plain versions: both round every operation once in the same order, so they
# agree to the bit (the first readings on the H100: 0 in f64 and f32); the limits below hold them, with
# the NaN masks of kernel and plain required equal. The KL and glasso paths against their plain paths, f64:
# Q's data 1e-9 (the KL path's plain run is on CPU tensors, whose exp and sqrt in the cov_fn differ from
# the card's in the last bit, and each column's solve amplifies that by its block's condition, up to
# ~1/jitter: the first readings on the H100 were 3.6e-13 at n=900 and 1.1e-11 at n=10,000; on the card
# the glasso's Q is K5's sums in another order); logdet 1e-10; var, conditional means and logpdf 1e-8 (the
# dense and supernodal Choleskys of a precision of condition up to ~1e8 round in another order).
SN_TOL[torch.float64].update(kl_columns=1e-12, block_inv=1e-10)
SN_TOL[torch.float32].update(kl_columns=1e-4, block_inv=1e-3)
PATH_TOL = {"data": 1e-9, "logdet": 1e-10, "stat": 1e-8}


# Phases 3f and 17: the SPIKE solve (tpu_gmrf/parallel/pbtridiag.py) at full width, Q = Q_t ⊗ Q_s: Q_t the
# AR1Model precision over Nt = 128 steps (τ = 1, ρ = 0.9), Q_s the Matérn α=2 precision on the g=16 mesh
# (ns = 450 at τ = 1, range 0.25: the dense backend's shape of phase 10), in P = 4 chunks of 32 slices, f64:
# diag[t] = Q_t[t, t]·Q_s, sub[t] = Q_t[t+1, t]·Q_s. Example 12 part 3 (examples/12_multichip_sharding.py:
# 104-134) as written: P = 8, Nt = 4P, ns = 8, f32, seed 3, with its own limits.
SPIKE_NT, SPIKE_P, SPIKE_RHO = 128, 4, 0.9
EX12_P, EX12_NS, EX12_SEED = 8, 8, 3
EX12_LIMITS = {"x": 1e-3, "logdet": 0.05}
SPIKE_KERNELS = ("bt_factor_blocks", "bt_trsv_blocks", "spike_reduced")
# K11's and K12's block entries and K18 against their plain versions, normwise: float64 exact up to rounding
# order, 1e-12. float32 (at the main shape the same Matérn blocks): set from the first readings on the H100
# (factor 4.0e-7, block solve 2.5e-6, K18 6.2e-6), about ten times above them.
SN_TOL[torch.float64].update(bt_factor_blocks=1e-12, bt_trsv_blocks=1e-12, spike_reduced=1e-12)
SN_TOL[torch.float32].update(bt_factor_blocks=4e-6, bt_trsv_blocks=3e-5, spike_reduced=6e-5)
# Phase 17 against its oracles, f64, normwise: x against the supernodal solve of the assembled Q and the
# residual ‖Qx − b‖/‖b‖ 1e-9 (two factorizations of a matrix of condition ~1e5 in different orders); the
# logdet 1e-10 relative; the gradients of bᵀQ⁻¹b against the plain path on CPU tensors 1e-9; the public
# entry on a one-rank NCCL mesh (one chunk, not four) against the in-process solve 1e-9; the supernodal
# factor on a one-rank mesh equal to the unsharded one (the same launches).
SPIKE_TOL = {"x": 1e-9, "residual": 1e-9, "logdet": 1e-10, "grad": 1e-9, "public": 1e-9}
# Phase 18, fault 3.1 on the card, f64: d/dτ through the solves held to 1e-8 relative against the plain path
# on CPU tensors and against a central difference (h = 1e-6) on the n = 6 probe (the first readings on the
# H100: 2.5e-15 and 1.6e-9 at most). At the KL n = 900 setup d/dτ is held to 1e-8 against the plain path
# (read 8.3e-10 on the H100), against the forward derivative 1ᵀ Q_post⁻¹ Q (μ₀ − μ) from two more solves
# (read 6.5e-9 on the H100) and against a central difference at h = 1e-5. The conditioned mean sum is ~80 with
# d/dτ ~ −0.013 and Q has condition up to 1/jitter = 1e8, so subtracting two sums cannot resolve 1e-8 at any
# h; the difference is therefore computed as (f(1+h) − f(1−h))/2h = 1ᵀ Q_post(1+h)⁻¹ Q (μ₀ − μ(1−h)), an
# identity, with no subtraction of the sums (on a CPU: 3.2e-10 from autograd, 6.4e-9 from jax.grad of the
# JAX package, which tests/test_torch_solve_grad.py holds to 1e-8).
FAULT_TOL = {"grad": 1e-8, "kl_fwd": 1e-8, "kl_cd": 1e-8}
FAULT_KERNELS = ("tridiag_factor", "tridiag_solve", "dense_chol", "dense_trsv", "bt_factor", "bt_trsv", "fct_init",
                 "sn_panel", "sn_trsv", "gather_segsum")


def rbmc_tol(S: int) -> dict:
    sigma = (2.0 / (S - 1)) ** 0.5
    return {"max": 6 * sigma, "mean": 1.5 * sigma}


_PHASE: dict = {}


def log(msg: str) -> None:
    """Print a line; a line that opens a phase first prints the seconds since
    the previous phase's line."""
    if msg.startswith("phase ") or msg.startswith("total "):
        now = time.perf_counter()
        if _PHASE:
            print(f"  ({_PHASE['name']}: {now - _PHASE['t']:.1f} s)", flush=True)
        _PHASE.update(name=msg.split(":")[0][:48], t=now)
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Mean time of fn() over `reps` runs by CUDA events (the device timeline,
    host gaps between launches included), after a warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype) -> dict:
    """bound_ms / bound_by of a function of `flops` operations moving `nbytes`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def table_bytes(*plans) -> int:
    """Bytes of the int tables (NumPy arrays) a plan object holds."""
    return sum(a.nbytes for p in plans for a in vars(p).values() if isinstance(a, np.ndarray))


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, normwise relative error) over matching tensors."""
    err = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.double().abs().max()) for r in ref)
    return err, err / max(scale, 1e-300)


# ---- phase 3: kernels against their plain versions ---------------------------


def kernel_inputs(dtype, dev):
    """Flagship-shaped inputs: AR1 posterior precisions Q_prior - H at random θ."""
    rng = np.random.default_rng(1)
    tau = np.exp(rng.normal(scale=0.5, size=(CHAINS, 1)))
    rho = np.tanh(rng.normal(scale=0.7, size=(CHAINS, 1)))
    hess = np.exp(rng.normal(scale=0.8, size=(CHAINS, N)))  # -∇² Poisson loglik = exp(x)
    a = np.concatenate([tau, np.repeat(tau * (1 + rho**2), N - 2, 1), tau], 1) + hess
    c = np.repeat(-rho * tau, N - 1, 1)
    x = rng.normal(size=(CHAINS, N))
    b = rng.normal(size=(CHAINS, N))
    return [torch.tensor(v, dtype=dtype, device=dev) for v in (a, c, x, b)]


def check_kernels(dtype, dev):
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.sparse.matrix import _csr, sp_tridiag

    a, c, x, b = kernel_inputs(dtype, dev)
    d, e, _ = kernels.tridiag_factor_plain(a, c)
    Q = sp_tridiag(a, c)
    rp, col = _csr(Q.pattern, dev)
    data = Q.data.contiguous()
    el, nnz = a.element_size(), col.numel()
    costs = {  # (operations, bytes): inputs read once, outputs written once
        "tridiag_factor": (5 * CHAINS * N, el * CHAINS * (4 * N - 1)),  # a, c in; d, e, logdet out
        "tridiag_solve": (6 * CHAINS * N, el * CHAINS * (4 * N - 1)),  # d, e, b in; x out
        "tridiag_selinv": (5 * CHAINS * N, el * CHAINS * (4 * N - 2)),  # d, e in; zdiag, zoff out
        "csr_spmv": (2 * CHAINS * (nnz + N), 4 * (N + 1 + nnz) + el * CHAINS * (nnz + 2 * N + 1)),
    }
    # the library call beside K4: one CSR product, the chains as a block-diagonal matrix
    crow = torch.cat([rp[:-1].long() + b * nnz for b in range(CHAINS)]
                     + [torch.tensor([CHAINS * nnz], device=dev)])
    with warnings.catch_warnings():  # "beta" and invariant-check notices of sparse CSR
        warnings.simplefilter("ignore", UserWarning)
        bd = torch.sparse_csr_tensor(crow, torch.cat([col.long() + b * N for b in range(CHAINS)]), data.reshape(-1),
                                     size=(CHAINS * N, CHAINS * N))
    xcol = x.reshape(-1, 1).contiguous()
    library = {"csr_spmv": lambda: torch.sparse.mm(bd, xcol)}
    cases = {
        "tridiag_factor": (lambda: kernels.tridiag_factor(a, c), lambda: kernels.tridiag_factor_plain(a, c)),
        "tridiag_solve": (lambda: kernels.tridiag_solve(d, e, b), lambda: kernels.tridiag_solve_plain(d, e, b)),
        "tridiag_selinv": (lambda: kernels.tridiag_selinv(d, e), lambda: kernels.tridiag_selinv_plain(d, e)),
        "csr_spmv": (lambda: kernels.csr_spmv(rp, col, data, x, quad=True),
                     lambda: kernels.csr_spmv_plain(rp, col, data, x, quad=True)),
    }
    results = {}
    name_t = "f32" if dtype == torch.float32 else "f64"
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{name} {name_t}: non-finite kernel output")
        abs_err, rel = rel_err(got, ref)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        lib_ms = cuda_ms(library[name]) if name in library else None
        bnd = bound(*costs[name], dtype)
        log(f"kernel {name} {name_t} B={CHAINS} n={N}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
            f"(tol {KERNEL_TOL[dtype]:.0e}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms} "
            f"bound_ms={bnd['bound_ms']:.5f} ({bnd['bound_by']})")
        if not rel <= KERNEL_TOL[dtype]:
            raise AssertionError(f"{name} {name_t}: kernel disagrees with its plain version ({rel:.3e})")
        results[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bnd,
                         "dtype": name_t, "shape": f"B={CHAINS} n={N}"}
    return results


# ---- the spatial model (phases 3b, 6, 7, 8) -------------------------------------


def grid_points(g: int) -> np.ndarray:
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def spatial_model(g: int):
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import native

    t0 = time.perf_counter()
    model = tg.MaternModel(grid_points(g), smoothness=1, solver=tg.SolverSpec(kind="supernodal"))
    mesh_s = time.perf_counter() - t0
    from tpu_gmrf_torch.solvers.supernodal import supernodal_plan

    t0 = time.perf_counter()
    Q = model.precision(tau=torch.tensor(1.0, dtype=torch.float64), range=torch.tensor(0.25, dtype=torch.float64))
    plan = supernodal_plan(Q.pattern, 2048, "auto")
    plan_s = time.perf_counter() - t0
    plan_by = "native C++" if native.native_available() else "NumPy fallback"
    log(f"  g={g}: n={model.n}, nnz(Q)={Q.nnz}, nnz(L)={plan['nnzL']}, supernodes={plan['nsuper']}, "
        f"levels={plan['nlevels']}; mesh+FEM {mesh_s:.2f} s, precision+plan {plan_s:.2f} s (plan by {plan_by})")
    return model


def spatial_y(model, g: int) -> np.ndarray:
    """Counts as bench.py:256-265: Poisson(exp(clip(sin 3x cos 2y))) on the grid nodes, seed 1."""
    rng = np.random.default_rng(1)
    pts = grid_points(g)
    field = np.zeros(model.n, np.float32)
    field[: pts.shape[0]] = np.sin(3.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    return rng.poisson(np.exp(np.clip(field, -3, 3))).astype(np.float32)


def check(name: str, dtype, got, ref, tol_key: str, results: dict, ms=None, plain_ms=None, extra="",
          cost=None, library_ms=None, shape=""):
    torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{name}: non-finite kernel output")
    abs_err, rel = rel_err(got, ref)
    tol = SN_TOL[dtype][tol_key]
    bnd = bound(*cost, dtype) if cost is not None else None
    times = f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}" if ms is not None else ""
    if library_ms is not None:
        times += f" library_ms={library_ms:.3f}"
    if bnd is not None:
        times += f" bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})"
    log(f"  {name} {dtype_name(dtype)}: max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:.0e}){times}{extra}")
    if not rel <= tol:
        raise AssertionError(f"{name} {dtype_name(dtype)}: kernel disagrees with its plain version ({rel:.3e})")
    if ms is not None:
        results[tol_key] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            **(bnd or {}), "dtype": dtype_name(dtype), "shape": shape}


def dtype_name(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def plain_factorize(Q):
    """The supernodal factorization on the plain versions, whatever Q's device."""
    from tpu_gmrf_torch.solvers import supernodal as sn

    return sn._factorize(Q, 2048, "auto", sn._PLAIN_OPS)


def with_plain_steps(f):
    """A factor's solves and Σ on the plain versions (the factor values kept)."""
    from tpu_gmrf_torch.solvers import supernodal as sn

    return dataclasses.replace(f, _ops=sn._PLAIN_OPS)


def sn_costs(levels, B: int, el: int, nnz: int, nnzL: int, n: int) -> dict:
    """(operations, bytes) of a whole factorization (K6), solve (K7) and
    Takahashi sweep (K8) over the schedule's class batches, from each
    supernode's live width ns and live row count m (Cholesky ns³/3, panel
    solve m·ns², update m²·ns; the K5 reductions between levels, a few
    percent of the work, are not counted) and the bytes of the values and
    the class tables the steps read."""
    ns_all, m_all, tabs = [], [], {k: 0 for k in ("panel", "cols", "rows", "schur")}
    for lv in levels:
        for c in lv.classes:
            pan, W = c["panel"].cpu().numpy(), c["W"]
            ns_all.append((pan[:, np.arange(W), np.arange(W)] != c["dummy"]).sum(1))
            m_all.append((pan[:, W:, 0] != c["dummy"]).sum(1) if c["M"] else np.zeros(len(pan), np.int64))
            for k in tabs:
                tabs[k] += c[k].numel() * 4
    ns, m = np.concatenate(ns_all).astype(float), np.concatenate(m_all).astype(float)
    return {
        "sn_panel": (B * float(np.sum(ns**3 / 3 + m * ns**2 + m**2 * ns)),
                     el * B * (nnz + nnzL + 1) + tabs["panel"] + tabs["cols"]),
        "sn_trsv": (B * float(np.sum(2 * ns**2 + 4 * m * ns)),
                    el * B * (nnzL + 2 * n) + tabs["panel"] + tabs["cols"] + tabs["rows"]),
        "sn_takahashi": (B * float(np.sum(2 * ns**3 / 3 + 2 * m * ns**2 + 2 * m**2 * ns)),
                         el * B * 2 * (nnzL + 1) + tabs["panel"] + tabs["schur"]),
        "sn_multiply": (B * float(np.sum(ns**2 + 2 * m * ns)),
                        el * B * (nnzL + 2 * n) + tabs["panel"] + tabs["cols"]),
    }


def check_spatial_kernels(model, dtype, dev):
    """Phase 3b: K5-K8 against their plain versions at n=5741, B=4."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import supernodal as sn
    from tpu_gmrf_torch.fem.spde import range_to_kappa
    from tpu_gmrf_torch.sparse.matrix import _MUL_CACHE, spdiag

    B, n = SP_CHAINS, model.n
    rng = np.random.default_rng(3)
    tau = torch.ones(B, dtype=dtype, device=dev)
    rng_ = torch.full((B,), 0.25, dtype=dtype, device=dev)
    prior = model.precision(tau=tau, range=rng_)
    h = torch.tensor(np.exp(rng.normal(scale=0.5, size=(B, n))), dtype=dtype, device=dev)
    post = prior + spdiag(h)
    b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=dev)
    results = {}
    # K5: the SpGEMM Kᵀ(C⁻¹K) of the precision, forward and backward, and one ELL level
    K = model.spde.K(range_to_kappa(rng_, model.spde.nu))
    A, Bm = K.T, model.spde._on(rng_)["Cinv"] @ K
    fwd, back_a, _ = _MUL_CACHE[(A.pattern, Bm.pattern)][1]
    a, bd = A.data.contiguous(), Bm.data.contiguous()
    el, shape = a.element_size(), f"B={B} n={n}"
    check("gather_segsum sp_matmul fwd", dtype, kernels.gather_segsum(fwd, a, y=bd),
          kernels.gather_segsum_plain(fwd, a, y=bd), "gather_segsum", results,
          cuda_ms(lambda: kernels.gather_segsum(fwd, a, y=bd)),
          cuda_ms(lambda: kernels.gather_segsum_plain(fwd, a, y=bd)),
          cost=(2 * B * len(fwd.xi), table_bytes(fwd) + el * B * (a.shape[1] + bd.shape[1] + fwd.rows)),
          shape=shape)
    g = torch.tensor(rng.normal(size=(B, fwd.rows)), dtype=dtype, device=dev)
    check("gather_segsum sp_matmul bwd", dtype, kernels.gather_segsum(back_a, g, y=bd),
          kernels.gather_segsum_plain(back_a, g, y=bd), "gather_segsum", {})
    fk = sn.supernodal_factorize(post)
    dp = sn._device_plan(fk.meta, dev)
    # K5's fct_init: symmetrize, equilibrate, scatter onto the fill pattern
    nnzL = fk.vals.shape[1] - 1

    def init(fn):
        vals, s, nls = post.data.new_zeros(B, nnzL + 1), post.data.new_empty(B, n), post.data.new_empty(B, n)
        fn(dp["init"], post.data, vals, s, nls)
        return vals, s, nls

    check("fct_init", dtype, init(kernels.fct_init), init(kernels.fct_init_plain), "fct_init", results,
          cuda_ms(lambda: init(kernels.fct_init)), cuda_ms(lambda: init(kernels.fct_init_plain)),
          cost=(4 * B * post.nnz, table_bytes(dp["init"]) + el * B * (post.nnz + nnzL + 1 + 2 * n)), shape=shape)
    costs = sn_costs(dp["levels"], B, el, post.nnz, nnzL, n)
    levels = dp["levels"]
    lv = max(levels, key=lambda lv: sum(e.rows for e in lv.schur))
    u = torch.tensor(rng.normal(size=(B, lv.zu + 1)), dtype=dtype, device=dev)
    out0 = fk.vals.clone()
    ell = lambda f: [f(e, u, out=out0.clone(), alpha=-1.0, accumulate=True) for e in lv.schur]
    check("gather_segsum ELL level", dtype, ell(kernels.gather_segsum), ell(kernels.gather_segsum_plain),
          "gather_segsum", {}, extra=f" ({sum(e.rows for e in lv.schur)} rows)")
    for label, Q in (("prior", prior), ("posterior", post)):
        # K6 against the plain factorization; K7 and K8 against their plain
        # versions on the same (kernel) factor, so each check sees one kernel
        fk = sn.supernodal_factorize(Q)
        fp = plain_factorize(Q)
        fkp = with_plain_steps(fk)
        boosts = f" boost kernel={fk.boost.tolist()} plain={fp.boost.tolist()}"
        if dtype == torch.float64 and (fk.boost.any() or fp.boost.any()):
            raise AssertionError(f"{label}: float64 factor boosted a pivot")
        timing = label == "posterior"
        ms = (cuda_ms(lambda: sn.supernodal_factorize(Q), SN_REPS, 1),
              cuda_ms(lambda: plain_factorize(Q), SN_REPS, 1)) if timing else (None, None)
        check(f"sn_panel factor vals [{label}]", dtype, fk.vals, fp.vals, "sn_panel", results, *ms, extra=boosts,
              cost=costs["sn_panel"], shape=shape)
        check(f"sn_panel logdet [{label}]", dtype, fk.logdet(), fp.logdet(), "logdet", {},
              extra=f" logdet={fk.logdet().tolist()}")
        ms = (cuda_ms(lambda: fk.solve(b), SN_REPS, 1), cuda_ms(lambda: fkp.solve(b), SN_REPS, 1)) if timing \
            else (None, None)
        check(f"sn_trsv solve [{label}]", dtype, fk.solve(b), fkp.solve(b), "sn_trsv", results, *ms,
              cost=costs["sn_trsv"], shape=shape)
        ms = (cuda_ms(fk._sigma_vals, SN_REPS, 1), cuda_ms(fkp._sigma_vals, SN_REPS, 1)) if timing else (None, None)
        check(f"sn_takahashi sigma [{label}]", dtype, fk._sigma_vals(), fkp._sigma_vals(), "sn_takahashi",
              results, *ms, cost=costs["sn_takahashi"], shape=shape)
    return results


def gmrf_statistics(model, dev):
    """Phase 6: factorize, logdet, selinv_diag, solve, sample at n=14058, B=1."""
    from tpu_gmrf_torch.solvers import supernodal as sn

    n = model.n
    pts = model.disc.mesh.vertices
    mid = int(np.argmin(np.linalg.norm(pts - 0.5, axis=1)))
    rng = np.random.default_rng(4)
    var64 = None
    for dtype in (torch.float64, torch.float32):
        Q = model.precision(tau=torch.ones(1, dtype=dtype, device=dev),
                            range=torch.full((1,), 0.25, dtype=dtype, device=dev))
        b = torch.tensor(rng.normal(size=(1, n)), dtype=dtype, device=dev)
        with torch.no_grad():
            fk, fp = sn.supernodal_factorize(Q), plain_factorize(Q)
            fkp = with_plain_steps(fk)  # plain steps on the kernel's factor
            rows = []
            for name, kern, plain, key in (
                ("factorize", lambda: sn.supernodal_factorize(Q).vals,
                 lambda: plain_factorize(Q).vals, "sn_panel"),
                ("selinv_diag", fk.selinv_diag, fkp.selinv_diag, "sn_takahashi"),
                ("solve", lambda: fk.solve(b), lambda: fkp.solve(b), "sn_trsv"),
                ("sample", lambda: fk.backward_solve(b), lambda: fkp.backward_solve(b), "sn_trsv"),
            ):
                got, ref = kern(), plain()
                ms, pms = cuda_ms(kern, 3, 1), cuda_ms(plain, 3, 1)
                check(f"{name} n={n}", dtype, got, ref, key, {}, ms, pms)
                rows.append(f"{name} {ms:.2f}/{pms:.2f}")
            var = fk.selinv_diag()[0, mid].item()
            if dtype == torch.float64:
                var64 = fp.selinv_diag()[0, mid].item()
        log(f"  n={n} {dtype_name(dtype)} on card, kernel/plain ms: {', '.join(rows)}; logdet kernel "
            f"{fk.logdet().item():.6f} plain {fp.logdet().item():.6f}; var at node {mid} (nearest (0.5, 0.5)) "
            f"{var:.8e} (f64 plain {var64:.8e}); boost {fk.boost.tolist()}")


def spatial_logdensity(model, y, ga_iter: int = SP_GA_ITER, inner: str | None = "supernodal"):
    """The bench's log-density over (τ, range); `inner` None is the default
    (auto) inner solver."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import LogTransform, ParamSpec, make_logdensity

    spec = ParamSpec(
        tau=(LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
        range=(LogTransform(), lambda r: -0.5 * (torch.log(r) - np.log(0.3)) ** 2),
    )
    opts = tg.GAOptions(max_iter=ga_iter) if inner is None else \
        tg.GAOptions(max_iter=ga_iter, inner_solver=tg.SolverSpec(kind=inner))
    obs = tg.ExponentialFamily("poisson")
    return make_logdensity(lambda th: tg.laplace_marginal(model, obs, y, th, options=opts), spec)


def newton_iterations(model, y, z) -> int:
    """Iterations of the spatial slice's Laplace Newton loop (the slowest
    chain's) at θ = exp(z), counted from the loop's verbose lines."""
    import contextlib
    import io

    import tpu_gmrf_torch as tg

    theta = torch.exp(z)
    opts = tg.GAOptions(max_iter=SP_GA_ITER, inner_solver=tg.SolverSpec(kind="supernodal"), verbose=True)
    out = io.StringIO()
    with torch.no_grad(), contextlib.redirect_stdout(out):
        tg.laplace_marginal(model, tg.ExponentialFamily("poisson"), y, {"tau": theta[:, 0], "range": theta[:, 1]},
                            options=opts)
    return sum(line.startswith("newton it=") for line in out.getvalue().splitlines())


def profile_value_and_grad(ld, z):
    """Device busy time of one value+grad from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_gmrf_torch.samplers import value_and_grad

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value_and_grad(ld, z)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels_ = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in kernels_)
    log(f"  profile (f32, one value+grad): wall {wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.1f} ms in "
        f"{len(kernels_)} device activities, device idle {100.0 * (1 - dev_us / 1e6 / wall):.1f}%")
    by_name: dict = {}
    for e in kernels_:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {name[:70]:70s} calls={c} device_ms={t / 1e3:.2f}")


# ---- phases 4-5: the slice ----------------------------------------------------


def flagship_y() -> np.ndarray:
    """AR1(τ=1, ρ=0.7) path from seed 0, y ~ Poisson(exp(clip(x, -3, 3)))."""
    rng = np.random.default_rng(0)
    tau, rho = 1.0, 0.7
    x = np.empty(N)
    x[0] = rng.normal() / np.sqrt(tau * (1 - rho**2))
    for t in range(1, N):
        x[t] = rho * x[t - 1] + rng.normal() / np.sqrt(tau)
    return rng.poisson(np.exp(np.clip(x, -3, 3))).astype(np.float32)


def logdensity(y):
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import LogitTransform, LogTransform, ParamSpec, make_logdensity

    model, obs = tg.AR1Model(N), tg.ExponentialFamily("poisson")
    spec = ParamSpec(
        tau=(LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
        rho=(LogitTransform(-1.0, 1.0), lambda r: 0.0),
    )
    opts = tg.GAOptions(max_iter=GA_MAX_ITER)
    return make_logdensity(lambda th: tg.laplace_marginal(model, obs, y, th, options=opts), spec)


def tg_resolve(model) -> str:
    """The kind the default (auto) inner solver resolves to on `model`'s pattern."""
    import tpu_gmrf_torch as tg

    Q = model.precision(tau=torch.tensor(1.0, dtype=torch.float64), range=torch.tensor(0.3, dtype=torch.float64))
    return tg.SolverSpec().resolve(Q.pattern).kind


def launched(counts: dict, path: tuple, label: str) -> None:
    log(f"launches on the {label} main path: {counts}")
    missing = [k for k in path if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} main path: {missing}")


def slice_errors(v, g, ref_v, ref_g):
    """Max relative value error; max per-chain gradient error (normwise, scale ≥ 1); per-chain text."""
    v, g, ref_v, ref_g = (a.double().cpu() for a in (v, g, ref_v, ref_g))
    g_rel = (g - ref_g).abs().amax(-1) / ref_g.abs().amax(-1).clamp_min(1.0)
    per_chain = f" (per chain {', '.join(f'{x:.3e}' for x in g_rel.tolist())})" if g.shape[0] <= 8 else ""
    return float(((v - ref_v).abs() / ref_v.abs()).max()), float(g_rel.max()), per_chain


def check_slice(name, v, g, ref_v, ref_g, chains, tol_key, tol=SLICE_TOL, ref_name="f64 plain"):
    if not (torch.isfinite(v).all() and torch.isfinite(g).all()) or v.shape != (chains,) or g.shape != (chains, 2):
        raise AssertionError(f"slice {name}: non-finite or misshapen value/grad")
    v_rel, g_rel, per_chain = slice_errors(v, g, ref_v, ref_g)
    log(f"  slice {name} kernels vs {ref_name}: value max rel {v_rel:.3e} (tol {tol[tol_key + '_value']:.2g}), "
        f"grad max rel {g_rel:.3e} (tol {tol[tol_key + '_grad']:.2g}){per_chain}")
    if not (v_rel <= tol[tol_key + "_value"] and g_rel <= tol[tol_key + "_grad"]):
        raise AssertionError(f"slice {name}: disagrees with the {ref_name} path")


def run_hmc(ld, z, steps, step_size, dev):
    from tpu_gmrf_torch.samplers import hmc_init, hmc_kernel

    gen = torch.Generator(device=dev).manual_seed(1)
    step = hmc_kernel(ld, num_steps=LEAPFROG)
    state = hmc_init(ld, z)
    accepts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, info = step(gen, state, step_size, torch.ones(z.shape[-1], device=dev))
        accepts.append(info["accept_prob"].mean().item())
    torch.cuda.synchronize()
    return state, accepts, (time.perf_counter() - t0) / steps * 1e3


# ---- phase 3c: the dense and banded kernels -------------------------------------


def random_posterior(model, B: int, dtype, dev, seed: int):
    """B posterior-like precisions of `model`: the prior at τ=1, range=0.3
    plus a random positive diagonal (the Newton Hessian's role)."""
    from tpu_gmrf_torch.sparse.matrix import spdiag

    rng = np.random.default_rng(seed)
    Q = model.precision(tau=torch.ones(B, dtype=dtype, device=dev), range=torch.full((B,), 0.3, dtype=dtype, device=dev))
    return Q + spdiag(torch.tensor(np.exp(rng.normal(size=(B, model.n))), dtype=dtype, device=dev))


def check_dense_kernels(dn_model, sp_model, dtype, dev):
    """Phase 3c: K9-K10 at the g=16 posterior (B=8) and K11-K12 at n=5741
    (B=4) against their plain versions and their library calls."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as tb
    from tpu_gmrf_torch.solvers import dense as td

    results = {}
    B, n = DN_CHAINS, dn_model.n
    Q = random_posterior(dn_model, B, dtype, dev, 6)
    data, t, el, shape = Q.data.contiguous(), td._tables(Q.pattern), Q.data.element_size(), f"B={B} n={n}"
    got, ref = kernels.dense_chol(data, t), kernels.dense_chol_plain(data, t)
    if got[2].tolist() != ref[2].tolist() or got[2].any():
        raise AssertionError(f"dense_chol: rescue levels kernel {got[2].tolist()} plain {ref[2].tolist()}")
    L, s = got[0], got[1]
    A = L @ L.mT  # the equilibrated matrix K9 factors, for the library call
    check("dense_chol", dtype, (L, s, got[3]), (ref[0], ref[1], ref[3]), "dense_chol", results,
          cuda_ms(lambda: kernels.dense_chol(data, t)), cuda_ms(lambda: kernels.dense_chol_plain(data, t)),
          cost=(B * n**3 / 3, table_bytes(t) + el * B * (Q.nnz + n * n + n + 1)),
          library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(A)), shape=shape,
          extra=f" (library: torch.linalg.cholesky_ex of the equilibrated (B, n, n))")
    b = torch.tensor(np.random.default_rng(7).normal(size=(B, n, 1)), dtype=dtype, device=dev)
    sb = s[..., None] * b
    # the Newton solve: both triangles (mode 2), one right-hand side
    check("dense_trsv solve", dtype, kernels.dense_trsv(L, s, b, 2), kernels.dense_trsv_plain(L, s, b, 2),
          "dense_trsv", results, cuda_ms(lambda: kernels.dense_trsv(L, s, b, 2)),
          cuda_ms(lambda: kernels.dense_trsv_plain(L, s, b, 2)),
          cost=(B * 2 * n * n, el * B * (n * (n + 1) // 2 + 3 * n)),
          library_ms=cuda_ms(lambda: torch.cholesky_solve(sb, L)), shape=f"{shape} k=1",
          extra=" (library: torch.cholesky_solve, both triangles)")
    for mode, label in ((0, "L^-1"), (1, "L^-T")):
        check(f"dense_trsv {label}", dtype, kernels.dense_trsv(L, s, b, mode), kernels.dense_trsv_plain(L, s, b, mode),
              "dense_trsv", {}, extra=f" solve_triangular {cuda_ms(lambda: torch.linalg.solve_triangular(L, sb, upper=False)):.3f} ms"
              if mode == 0 else "")
    # K10's second entry: Σ on Q's pattern (DenseLogdet's backward, selinv)
    r, c = t.on(dev)["rows"], t.on(dev)["cols"]
    rl, cl = r.long(), c.long()
    terms = float((n - torch.maximum(rl, cl)).sum())  # products of the row dots: X is upper triangular
    check("dense_selinv Σ on Q's pattern", dtype, kernels.dense_selinv(L, s, r, c),
          kernels.dense_selinv_plain(L, s, r, c), "dense_selinv", results,
          cuda_ms(lambda: kernels.dense_selinv(L, s, r, c), 5), cuda_ms(lambda: kernels.dense_selinv_plain(L, s, r, c), 5),
          cost=(B * (n**3 / 3 + 2 * terms), 8 * Q.nnz + el * B * (n * (n + 1) // 2 + n + Q.nnz)),
          shape=f"{shape} m={Q.nnz}",
          extra=f" (library: none; torch.cholesky_inverse, all of Q⁻¹ without the gather, "
                f"{cuda_ms(lambda: torch.cholesky_inverse(L), 5):.3f} ms)")

    B, n = SP_CHAINS, sp_model.n
    Q = random_posterior(sp_model, B, dtype, dev, 8)
    data, t = Q.data.contiguous(), tb._tables(Q.pattern, None)
    K, sblk, shape = t.K, t.s, f"B={B} n={n} s={t.s} K={t.K}"
    P, boost, logdet = kernels.bt_factor(data, t)
    Pp, boostp, logdetp = kernels.bt_factor_plain(data, t)
    if boost.tolist() != boostp.tolist() or (dtype == torch.float64 and boost.any()):
        raise AssertionError(f"bt_factor: boosts kernel {boost.tolist()} plain {boostp.tolist()}")
    flops = B * sum(sblk**3 / 3 + (2 * sblk**3 if k < K - 1 else 0) for k in range(K))
    L = P[:, :, :sblk]
    A = (L @ L.mT).reshape(B * K, sblk, sblk)  # the blocks D_k − M_{k−1}M_{k−1}ᵀ that K11 factors
    Lm = L[:, : K - 1].reshape(-1, sblk, sblk)
    Em = (P[:, : K - 1, sblk:] @ L[:, : K - 1].mT).reshape(-1, sblk, sblk)  # E_k = M_k L_kᵀ
    check("bt_factor", dtype, (P, logdet), (Pp, logdetp), "bt_factor", results,
          cuda_ms(lambda: kernels.bt_factor(data, t), 5), cuda_ms(lambda: kernels.bt_factor_plain(data, t), 5),
          cost=(flops, table_bytes(t) + el * B * (Q.nnz + K * 2 * sblk * sblk + 1) + 4 * B), shape=shape,
          library_ms=cuda_ms(lambda: (torch.linalg.cholesky_ex(A), torch.linalg.solve_triangular(Lm, Em.mT, upper=False)),
                             5),
          extra=f" boost {boost.tolist()} (library: cholesky_ex of the K blocks + solve_triangular for M)")
    factors = check_bt_factor_cases(Q, data, dtype)
    rows = torch.tensor(np.random.default_rng(9).normal(size=(B, n)), dtype=dtype, device=dev)
    Lb, rb = L.reshape(B * K, sblk, sblk), rows.new_zeros(B * K, sblk, 1)
    rb.view(B, K * sblk)[:, :n] = rows[:, t.on(dev)["perm_l"]]  # the permuted, padded right-hand sides
    trsv_ms = cuda_ms(lambda: kernels.bt_trsv(P, t, rows, 1, 2))
    check("bt_trsv solve", dtype, kernels.bt_trsv(P, t, rows, 1, 2), kernels.bt_trsv_plain(P, t, rows, 1, 2),
          "bt_trsv", results, trsv_ms, cuda_ms(lambda: kernels.bt_trsv_plain(P, t, rows, 1, 2)),
          cost=(B * (2 * K * sblk**2 + 4 * (K - 1) * sblk**2),
                4 * n + el * B * (K * sblk * (sblk + 1) // 2 + (K - 1) * sblk**2 + 2 * n)), shape=f"{shape} k=1",
          library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
              Lb.mT, torch.linalg.solve_triangular(Lb, rb, upper=False), upper=True)),
          extra=" (library: solve_triangular both ways on each block)")
    inv_ms = cuda_ms(lambda: kernels.banded._bt_inverses(P))
    log(f"  bt_trsv split {dtype_name(dtype)}: inversion of the {B * K} blocks (invert_diag + invert_blocks) "
        f"{inv_ms:.3f} ms ({B * K * sblk**3 / 3:.3e} flops), gather + sweeps + scatter {trsv_ms - inv_ms:.3f} ms of "
        f"{trsv_ms:.3f}")
    check_bt_trsv_cases(P, t, factors, rows, dtype)
    # the banded Takahashi sweep: K8 once per block (W = M = s), off the NUTS path; its bound from K8's
    # own step count per block (ns = s, m = s rows below it, none below the last) and the factor's blocks
    # read once plus Σ's blocks written once
    meta = (Q.pattern, None)
    sweep_flops = B * sum(2 * sblk**3 / 3 + (2 * sblk**3 + 2 * sblk**3 if k < K - 1 else 0) for k in range(K))
    sweep_bytes = el * B * 2 * (K * sblk * (sblk + 1) // 2 + (K - 1) * sblk * sblk)
    sweep = bound(sweep_flops, sweep_bytes, dtype)
    check("sn_takahashi banded sigma", dtype, tb._sigma_vals(P, meta),
          tb._sigma_vals(P, meta, kernels.sn_takahashi_plain), "sn_takahashi", {},
          extra=f" kernel_ms={cuda_ms(lambda: tb._sigma_vals(P, meta), 3, 1):.3f} plain_ms="
                f"{cuda_ms(lambda: tb._sigma_vals(P, meta, kernels.sn_takahashi_plain), 3, 1):.3f} (whole sweep) "
                f"bound_ms={sweep['bound_ms']:.4f} ({sweep['bound_by']}; {sweep_flops:.3e} flops, "
                f"{sweep_bytes / 1e6:.1f} MB)")
    return results


def check_bt_factor_cases(Q, data, dtype):
    """Phase 3c: K11 at a block size that is not a multiple of its 64-row tiles (the plan's `block=8`), and
    through its rescue: chain 1 given an indefinite block (three diagonal entries lowered by 1e3), which
    breaks down in the cluster pass and is redone with the pivot boost; against the plain version, with equal
    boosts, held to SN_TOL. Returns {label: (P, tables)} of the two factors for K12."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as tb

    t8 = tb._tables(Q.pattern, 8)
    diag_pos = np.nonzero(np.asarray(Q.pattern.rows) == np.asarray(Q.pattern.cols))[0]
    forced = data.clone()
    forced[1, torch.as_tensor(diag_pos[2000:2003], device=data.device)] -= 1e3
    factors = {}
    for label, d, tables, want in ((f"block=8 (s={t8.s})", data, t8, None),
                                   ("forced rescue (chain 1 indefinite)", forced, tb._tables(Q.pattern, None), 1)):
        P, boost, logdet = kernels.bt_factor(d, tables)
        Pp, boostp, logdetp = kernels.bt_factor_plain(d, tables)
        if boost.tolist() != boostp.tolist() or (want is not None and not boost[want]):
            raise AssertionError(f"bt_factor {label}: boosts kernel {boost.tolist()} plain {boostp.tolist()}")
        check(f"bt_factor {label}", dtype, (P, logdet), (Pp, logdetp), "bt_factor", {},
              extra=f" boost {boost.tolist()} kernel_ms={cuda_ms(lambda: kernels.bt_factor(d, tables), 3):.3f}")
        factors[label] = P, tables
    return factors


def check_bt_trsv_cases(P, t, factors, rows, dtype):
    """Phase 3c: K12 beyond the Newton solve, against its plain version, held to SN_TOL: k = 8, 9 and 65
    right-hand sides per chain (8 and 9 straddle its column tiles of 8 and 64) at s=512, and modes 0, 1 and 2
    on the factors of `check_bt_factor_cases` (s=496, not a multiple of 64; the forced rescue's boosted
    blocks), k = 1 and 9."""
    from tpu_gmrf_torch import kernels

    B, n = rows.shape
    rng = np.random.default_rng(10)
    for k in (8, 9, 65):
        b = torch.tensor(rng.normal(size=(B * k, n)), dtype=dtype, device=rows.device)
        check(f"bt_trsv solve s={t.s} k={k}", dtype, kernels.bt_trsv(P, t, b, k, 2),
              kernels.bt_trsv_plain(P, t, b, k, 2), "bt_trsv", {},
              extra=f" kernel_ms={cuda_ms(lambda: kernels.bt_trsv(P, t, b, k, 2), 5):.3f}")
    for label, (Pf, tf) in [(f"s={t.s}", (P, t))] + list(factors.items()):
        for k in (1, 9):
            b = torch.tensor(rng.normal(size=(B * k, n)), dtype=dtype, device=rows.device)
            for mode in (0, 1, 2):
                if label == f"s={t.s}" and (k, mode) == (1, 2):
                    continue  # the Newton solve, held above
                check(f"bt_trsv mode {mode} k={k} {label}", dtype, kernels.bt_trsv(Pf, tf, b, k, mode),
                      kernels.bt_trsv_plain(Pf, tf, b, k, mode), "bt_trsv", {},
                      extra=f" kernel_ms={cuda_ms(lambda: kernels.bt_trsv(Pf, tf, b, k, mode), 5):.3f}"
                      if k == 1 else "")
    empty = kernels.bt_trsv(P, t, rows[:0], 0, 2)  # no right-hand sides: nothing to launch
    torch.cuda.synchronize()
    if empty.shape != (0, n):
        raise AssertionError(f"bt_trsv with k=0 returned {tuple(empty.shape)}")


# ---- phases 9-11: run_nuts ----------------------------------------------------------


def timed_nuts(ld, init, warmup: int, samples: int, depth: int, seed: int = 3):
    """run_nuts with its wall time (synchronized) and the launches it made."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tg.run_nuts(ld, seed, init, num_warmup=warmup, num_samples=samples, max_depth=depth)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launches()
    if not bool(torch.isfinite(res.samples).all()):
        raise AssertionError("run_nuts samples are not finite")
    return res, secs, counts


def timed_value_and_grad(ld, z):
    """One value+grad with its wall time in ms (synchronized) and the launches it made."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.samplers import value_and_grad

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = value_and_grad(ld, z)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, kernels.launches()


def nuts_line(res, secs: float) -> str:
    chains, samples = res.samples.shape[:2]
    return (f"{chains * samples / secs:.4f} samples/s ({chains} chains x {samples} draws in {secs:.1f} s, warmup "
            f"included), depth per sampling transition mean {res.depth.float().mean():.2f} max "
            f"{int(res.depth.max())}, mean acceptance {res.accept_prob.mean():.3f}, divergences "
            f"{int(res.diverging.sum())}, step sizes {[round(x, 4) for x in res.step_size.tolist()]}")


def nuts_fixed_draws(ld, z, step_size, inv_mass, depth: int, dev):
    """One NUTS transition with the same fixed draws on the kernels (CUDA
    tensors) and on the plain path (CPU tensors, float64)."""
    from tpu_gmrf_torch.samplers import NUTSDraws, hmc_init, nuts_transition

    gen = torch.Generator().manual_seed(11)
    B, d = z.shape
    kw = dict(generator=gen, dtype=torch.float64)
    im = inv_mass.double().cpu()
    draws = NUTSDraws(torch.randn((B, d), **kw) * torch.sqrt(1.0 / im), torch.rand((B, depth), **kw),
                      torch.rand((B, depth), **kw), torch.rand((B, depth, 2 ** (depth - 1)), **kw))
    out = {}
    for where in (dev, torch.device("cpu")):
        zz = z.double().to(where)
        dr = NUTSDraws(*(x.to(where) for x in draws))
        t0 = time.perf_counter()
        out[where.type] = nuts_transition(ld, hmc_init(ld, zz), dr, step_size.double().to(where), im.to(where), depth)
        out[where.type + "_s"] = time.perf_counter() - t0
    return out


# ---- phases 3 (extended), 3d, 12-14: the matrix-free path ---------------------------


def unbatched(Q):
    """A (1, nnz) precision as one matrix, data (nnz,)."""
    from tpu_gmrf_torch.sparse.matrix import SparseMatrix

    return SparseMatrix(Q.data.reshape(-1).contiguous(), Q.pattern)


def matern_precision(model, dtype, dev):
    """The bench_spmv operator: `model`'s precision at τ=1, range=0.25, data (nnz,)."""
    return unbatched(model.precision(tau=torch.ones(1, dtype=dtype, device=dev),
                                     range=torch.full((1,), 0.25, dtype=dtype, device=dev)))


def grid_precision(dtype, dev):
    from tpu_gmrf_torch.models import grid_matern2_precision

    return grid_matern2_precision(CG_GRID, dtype=dtype, device=dev)


def formulation(mv, Q) -> tuple[str, str]:
    """(label, kernel name) of the multiply `hot_matvec(Q)` returned."""
    from tpu_gmrf_torch.solvers.banded import BlockTridiagMV

    if isinstance(mv, BlockTridiagMV):
        return "block_tridiag (K13)", "bt_matvec"
    if getattr(mv, "__self__", None) is Q:
        return "csr (K4)", "csr_spmv"
    return "bsr (K14)", "bsr_spmm"


def csr_library(Q):
    """Q as a torch CSR tensor, for the library product beside K4, K13 and K14."""
    from tpu_gmrf_torch.sparse.matrix import _csr

    rp, col = _csr(Q.pattern, Q.data.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(rp.long(), col.long(), Q.data, size=Q.shape)


def spmv_cost(Q, rows: int, el: int):
    """(operations, bytes) of K4 on `rows` vectors with shared values."""
    n = Q.shape[0]
    return 2 * rows * (Q.nnz + n), 4 * (n + 1 + Q.nnz) + el * (Q.nnz + rows * (2 * n + 1))


def check_beyond_shared_memory(model, dev):
    """Phase 3 (extended): K4 at n=14058 on its tiled path, and K1-K3 at
    n=20000 with their rows in global memory."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.sparse.matrix import _csr

    rng = np.random.default_rng(12)
    for dtype in (torch.float64, torch.float32):
        Q = matern_precision(model, dtype, dev)
        n, el = Q.shape[0], Q.data.element_size()
        rp, col = _csr(Q.pattern, dev)
        lib = csr_library(Q)
        for B in (1, 8):
            x = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=dev)
            xt = x.T.contiguous()
            scale = torch.linspace(1.0, 2.0, B, dtype=dtype, device=dev)[:, None]
            for label, data in (("shared", Q.data), ("per chain", (Q.data[None] * scale).contiguous())):
                path = kernels.spmv_path(n, B, dtype)
                if path != "tiled":
                    raise AssertionError(f"csr_spmv at n={n} B={B} took the {path} path")
                kern = lambda: kernels.csr_spmv(rp, col, data, x, quad=True)
                plain = lambda: kernels.csr_spmv_plain(rp, col, data, x, quad=True)
                shared = data.ndim == 1
                if shared:  # the library product computes the same y (not the quadratic form)
                    _, rel = rel_err((kern()[0],), (torch.sparse.mm(lib, xt).T,))
                    if not rel <= SN_TOL[dtype]["csr_spmv"]:
                        raise AssertionError(f"csr_spmv disagrees with CSR torch.sparse.mm ({rel:.3e})")
                ops, nbytes = spmv_cost(Q, B, el)
                check(f"csr_spmv n={n} B={B} values {label}, quad ({path} path)", dtype, kern(), plain(), "csr_spmv", {},
                      cuda_ms(kern), cuda_ms(plain), cost=(ops, nbytes + (0 if shared else el * (B - 1) * Q.nnz)),
                      library_ms=cuda_ms(lambda: torch.sparse.mm(lib, xt)) if shared else None)
        B, n = 4, 20000
        a = torch.tensor(2.5 + rng.random((B, n)), dtype=dtype, device=dev)
        c = torch.tensor(-rng.random((B, n - 1)), dtype=dtype, device=dev)
        b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=dev)
        if kernels.tridiag_path(n, 1, dtype) != "global" or kernels.tridiag_path(n, 0, dtype) != "global":
            raise AssertionError("n=20000 was expected on the global-memory path of K1-K3")
        d, e, _ = kernels.tridiag_factor_plain(a, c)
        for name, kern, plain, cost in (  # (operations, bytes) of each: inputs read once, outputs written once
            ("tridiag_factor", lambda: kernels.tridiag_factor(a, c), lambda: kernels.tridiag_factor_plain(a, c),
             (5 * B * n, el * B * (4 * n - 1))),
            ("tridiag_solve", lambda: kernels.tridiag_solve(d, e, b), lambda: kernels.tridiag_solve_plain(d, e, b),
             (6 * B * n, el * B * (4 * n - 1))),
            ("tridiag_selinv", lambda: kernels.tridiag_selinv(d, e), lambda: kernels.tridiag_selinv_plain(d, e),
             (5 * B * n, el * B * (4 * n - 2))),
        ):
            check(f"{name} n={n} B={B} (rows in global memory)", dtype, kern(), plain(), "tridiag", {},
                  cuda_ms(kern, 5), cuda_ms(plain, 5), cost=cost)
    # the user's entry points at the sizes that used to raise
    import tpu_gmrf_torch as tg

    with torch.no_grad():
        g = tg.AR1Model(20000)(tau=torch.tensor(1.3, dtype=torch.float64, device=dev),
                               rho=torch.tensor(0.6, dtype=torch.float64, device=dev))
        x = torch.tensor(rng.normal(size=20000), dtype=torch.float64, device=dev)
        got = (g.logpdf(x), g.var(), g.solve(x))
    var_ref = 1.0 / (1.3 * (1.0 - 0.6**2))  # the interior marginal variance of a stationary AR1
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in got) or abs(got[1][10000].item() / var_ref - 1.0) > 1e-8:
        raise AssertionError("AR1Model(20000) statistics are wrong")
    log(f"  AR1Model(20000) f64: logpdf {got[0].item():.6f}, interior var {got[1][10000].item():.10f} "
        f"(closed form {var_ref:.10f}), solve finite")


def bsr_library(Bm, dev):
    """A BSRMatrix as torch.sparse_bsr_tensor (the yardstick beside K14)."""
    t = Bm.plan.on(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_bsr_tensor(t["rowptr_l"], t["block_cols_l"], Bm.blocks,
                                       size=(Bm.plan.nb * Bm.plan.bs,) * 2)


def check_operator_kernels(label, Q, dtype, dev, results, block_sizes, timed):
    """K13, K14 (forward and transposed), K15 and K4 on one operator Q
    (data (nnz,)) with SPMV_VECS vectors, against plain and library."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.kernels.bsr_spmv import bsr_spmv
    from tpu_gmrf_torch.solvers.banded import block_tridiag_matvec
    from tpu_gmrf_torch.sparse.matrix import _csr

    rng = np.random.default_rng(13)
    n, k, el = Q.shape[0], SPMV_VECS, Q.data.element_size()
    x = torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=dev)
    g = torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=dev)
    xt, lib = x.T.contiguous(), csr_library(Q)
    lib_ms = cuda_ms(lambda: torch.sparse.mm(lib, xt))
    rp, col = _csr(Q.pattern, dev)
    shape = f"{label} n={n} k={k}"
    res = results if timed else {}
    check(f"csr_spmv {shape}", dtype, kernels.csr_spmv(rp, col, Q.data, x)[0], kernels.csr_spmv_plain(rp, col, Q.data, x)[0],
          "csr_spmv", {}, cuda_ms(lambda: kernels.csr_spmv(rp, col, Q.data, x)),
          cuda_ms(lambda: kernels.csr_spmv_plain(rp, col, Q.data, x)), cost=spmv_cost(Q, k, el), library_ms=lib_ms)
    with torch.no_grad():
        mv = block_tridiag_matvec(Q)
        K, s = mv.D.shape[0], mv.D.shape[1]
        dense = (2 * K - 1) * s * s
        check(f"bt_matvec {shape} s={s} K={K} ({dense * el / 1e6:.1f} MB of blocks)", dtype, mv(x),
              kernels.bt_matvec_plain(mv.D, mv.E, mv.perm, x), "bt_matvec", res, cuda_ms(lambda: mv(x)),
              cuda_ms(lambda: kernels.bt_matvec_plain(mv.D, mv.E, mv.perm, x)),
              cost=(2 * (3 * K - 2) * s * s * k, el * (dense + 2 * n * k) + 4 * n), library_ms=lib_ms,
              shape=f"{shape} s={s} K={K}", extra=" (library: CSR torch.sparse.mm)")
        _, rel = rel_err((mv(x),), (torch.sparse.mm(lib, xt).T,))
        if not rel <= SN_TOL[dtype]["bt_matvec"]:
            raise AssertionError(f"bt_matvec disagrees with CSR torch.sparse.mm ({rel:.3e})")
        log(bt_matvec_traffic(K, s, n, k, el, res.get("bt_matvec", {}).get("ms") if timed else cuda_ms(lambda: mv(x))))
    del mv
    best = kernels.best_block_size(Q.pattern)
    for bs in block_sizes:
        Bm = kernels.bsr_from_sparse(Q, bs)
        plan, blocks = Bm.plan, Bm.blocks
        nbl = plan.nblocks
        keep = res if bs == best else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            bl = bsr_library(Bm, dev)
            xpad = torch.nn.functional.pad(xt, (0, 0, 0, plan.nb * bs - n))
            bsr_ms = cuda_ms(lambda: bl @ xpad)
        cost = (2 * nbl * bs * bs * k, el * (nbl * bs * bs + 2 * n * k) + 4 * (nbl + plan.nb + 1))
        tag = f"{shape} bs={bs} nblocks={nbl}" + (" (best_block_size)" if bs == best else "")
        check(f"bsr_spmm {tag}", dtype, kernels.bsr_spmm(blocks, plan, x), kernels.bsr_spmm_plain(blocks, plan, x),
              "bsr_spmm", keep, cuda_ms(lambda: kernels.bsr_spmm(blocks, plan, x)),
              cuda_ms(lambda: kernels.bsr_spmm_plain(blocks, plan, x)), cost=cost, library_ms=bsr_ms, shape=tag,
              extra=" (library: torch.sparse_bsr_tensor @ x)")
        check(f"bsr_spmm transposed {tag}", dtype, kernels.bsr_spmm(blocks, plan, x, True),
              kernels.bsr_spmm_plain(blocks, plan, x, True), "bsr_spmm", {},
              cuda_ms(lambda: kernels.bsr_spmm(blocks, plan, x, True)),
              cuda_ms(lambda: kernels.bsr_spmm_plain(blocks, plan, x, True)))
        check(f"bsr_outer {tag}", dtype, kernels.bsr_outer(plan, g, x), kernels.bsr_outer_plain(plan, g, x),
              "bsr_outer", keep, cuda_ms(lambda: kernels.bsr_outer(plan, g, x)),
              cuda_ms(lambda: kernels.bsr_outer_plain(plan, g, x)),
              cost=(2 * nbl * bs * bs * k, el * (nbl * bs * bs + 2 * n * k) + 8 * nbl), shape=tag)
        if bs == best:  # the gradient of the BSR product against the plain version's autograd
            grads = []
            xs = x / kernels.bsr_spmm(blocks, plan, x).abs().max()  # sin's argument of order one
            for fn in (lambda b_, x_: bsr_spmv(b_, x_, plan), lambda b_, x_: kernels.bsr_spmm_plain(b_, plan, x_)):
                b_, x_ = blocks.clone().requires_grad_(), xs.clone().requires_grad_()
                torch.sin(fn(b_, x_)).sum().backward()
                grads.append((b_.grad, x_.grad))
            check(f"bsr_spmv gradient (blocks, x) {tag}", dtype, grads[0], grads[1], "bsr_outer", {})


def bt_matvec_traffic(K: int, s: int, n: int, k: int, el: int, ms: float,
                      how: str = "CUDA events, host gaps included") -> str:
    """What K13 moves for one product of k vectors with shared blocks (its own split) and the rate at `ms`."""
    from tpu_gmrf_torch.kernels.banded import matvec_split

    sp = matvec_split(s, K, k, 1, el)
    blocks = sp["chunks"] * (2 * K - 1) * s * s * el  # the blocks, once per chunk of vectors
    rest = el * (2 * k * n + 2 * sp["work"])  # x and y; the permuted rows and partials, written once and read once
    return (f"  bt_matvec reads and writes {(blocks + rest) / 1e6:.2f} MB ({blocks / 1e6:.2f} MB of blocks, "
            f"{rest / 1e6:.2f} MB of vectors and partials; split {sp}): {(blocks + rest) / ms / 1e6:.0f} GB/s at "
            f"{ms:.4f} ms ({how}), the blocks alone {blocks / ms / 1e6:.0f} GB/s")


def check_matvec_edges(sp_model, dtype, dev):
    """Phase 3d: K13 at its edges against its plain version, held to SN_TOL: one block (K = 1, n below s), blocks
    of 91 and 96 rows (not multiples of 64) with 9 vectors (two chunks of 8), per-chain blocks (D (B, K, s, s))
    with one vector per chain; and bt_sqrt at phase 14's shape (one n=5741 factor, 4 columns)."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as tb

    rng = np.random.default_rng(16)
    A = rng.normal(size=(70, 70))
    D1 = torch.tensor(A + A.T, dtype=dtype, device=dev)[None]
    perm = torch.tensor(rng.permutation(60), dtype=torch.int32, device=dev)
    x = torch.tensor(rng.normal(size=(3, 60)), dtype=dtype, device=dev)
    E1 = D1.new_zeros(0, 70, 70)
    check("bt_matvec K=1 s=70 n=60 k=3", dtype, kernels.bt_matvec(D1, E1, perm, x),
          kernels.bt_matvec_plain(D1, E1, perm, x), "bt_matvec", {})
    if kernels.bt_matvec(D1, E1, perm, x[:0]).shape != (0, 60):  # no vectors: nothing to launch
        raise AssertionError("bt_matvec with no vectors returned the wrong shape")
    small = spatial_model(12)
    Q = matern_precision(small, dtype, dev)
    for block in (13, 24):
        with torch.no_grad():
            mv = tb.block_tridiag_matvec(Q, block)
        K, s = mv.D.shape[0], mv.D.shape[1]
        x = torch.tensor(rng.normal(size=(9, Q.shape[0])), dtype=dtype, device=dev)
        check(f"bt_matvec s={s} K={K} k=9", dtype, kernels.bt_matvec(mv.D, mv.E, mv.perm, x),
              kernels.bt_matvec_plain(mv.D, mv.E, mv.perm, x), "bt_matvec", {})
        D2, E2 = torch.stack([mv.D, 2 * mv.D, -mv.D]), torch.stack([mv.E, 2 * mv.E, -mv.E])
        x2 = x[:3].contiguous()
        check(f"bt_matvec per chain B=3 s={s} K={K}", dtype, kernels.bt_matvec(D2, E2, mv.perm, x2),
              kernels.bt_matvec_plain(D2, E2, mv.perm, x2), "bt_matvec", {})
    with torch.no_grad():
        f = tb.banded_factorize(matern_precision(sp_model, dtype, dev))
    t = tb._TABLES[f.meta]
    z = torch.tensor(rng.normal(size=(4, sp_model.n)), dtype=dtype, device=dev)
    check(f"bt_sqrt phase 14's shape B=1 n={sp_model.n} s={t.s} K={t.K} k=4", dtype, kernels.bt_sqrt(f.P, t, z, 4),
          kernels.bt_sqrt_plain(f.P, t, z, 4), "bt_sqrt", {},
          extra=f" kernel_ms={cuda_ms(lambda: kernels.bt_sqrt(f.P, t, z, 4)):.4f} "
                f"plain_ms={cuda_ms(lambda: kernels.bt_sqrt_plain(f.P, t, z, 4)):.4f}")


def check_multiply_kernels(stats_model, sp_model, grid_q, dtype, dev):
    """Phase 3d."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as tb
    from tpu_gmrf_torch.solvers import supernodal as sn

    results = {}
    Q = matern_precision(stats_model, dtype, dev)
    check_operator_kernels("Matérn", Q, dtype, dev, results, (8, 16, 32), timed=True)
    check_operator_kernels("grid", grid_q[dtype], dtype, dev, results, (kernels.best_block_size(grid_q[dtype].pattern),),
                           timed=False)
    check_matvec_edges(sp_model, dtype, dev)
    rng = np.random.default_rng(14)
    with torch.no_grad():
        # bt_sqrt on the banded factor of phase 3c's shape
        B, n, el = SP_CHAINS, sp_model.n, Q.data.element_size()
        f = tb.banded_factorize(random_posterior(sp_model, B, dtype, dev, 8))
        t = tb._TABLES[f.meta]
        z = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=dev)
        elems = t.K * t.s * (t.s + 1) // 2 + (t.K - 1) * t.s * t.s
        check(f"bt_sqrt B={B} n={n} s={t.s} K={t.K}", dtype, kernels.bt_sqrt(f.P, t, z), kernels.bt_sqrt_plain(f.P, t, z),
              "bt_sqrt", results, cuda_ms(lambda: kernels.bt_sqrt(f.P, t, z)),
              cuda_ms(lambda: kernels.bt_sqrt_plain(f.P, t, z)),
              cost=(2 * B * elems, el * B * (elems + 2 * n) + 4 * n), shape=f"B={B} n={n} s={t.s} K={t.K} k=1")
        check("bt_sqrt: sqrt_matvec(forward_solve(z)) = z", dtype, f.sqrt_matvec(f.forward_solve(z)), z,
              "identity", {})
        del f
        # K7's multiply mode over the n=14058 schedule
        Q1 = stats_model.precision(tau=torch.ones(1, dtype=dtype, device=dev),
                                   range=torch.full((1,), 0.25, dtype=dtype, device=dev))
        fk = sn.supernodal_factorize(Q1)
        fkp = with_plain_steps(fk)
        n = stats_model.n
        z = torch.tensor(rng.normal(size=(1, n)), dtype=dtype, device=dev)
        nnzL = fk.vals.shape[1] - 1
        cost = sn_costs(sn._device_plan(fk.meta, dev)["levels"], 1, el, Q1.nnz, nnzL, n)["sn_multiply"]
        w = fk.sqrt_matvec(z)
        check(f"sn_multiply sqrt_matvec n={n}", dtype, w, fkp.sqrt_matvec(z), "sn_multiply", results,
              cuda_ms(lambda: fk.sqrt_matvec(z), SN_REPS, 1), cuda_ms(lambda: fkp.sqrt_matvec(z), SN_REPS, 1),
              cost=cost, shape=f"B=1 n={n}")
        quad, zz = (w * fk.solve(w)).sum().item(), (z * z).sum().item()
        log(f"  sqrt_matvec identity wᵀ solve(w) = zᵀz, {dtype_name(dtype)}: {quad:.8e} vs {zz:.8e} "
            f"(rel {abs(quad / zz - 1):.3e})")
        if dtype == torch.float64 and abs(quad / zz - 1) > 1e-8:
            raise AssertionError("supernodal sqrt_matvec fails wᵀ Q⁻¹ w = zᵀz")
    return results


def device_idle(fn) -> tuple[float, float]:
    """(wall ms, device idle share) of fn() from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.device_time_total for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, 1.0 - busy_us / 1e6 / wall


def kernel_device_ms(fn, kernels: tuple, calls: int) -> float:
    """Device time (ms) per call of the launches whose names hold one of
    `kernels` inside fn(), which makes `calls` calls, from a torch.profiler
    trace: no host gaps in it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in kernels)]
    if not times:
        raise AssertionError(f"the trace shows no launch of {kernels}")
    return sum(times) / calls / 1e3


def multiply_path(model, dev, card):
    """Phase 12: bench_spmv as the reference wrote it (bench.py:507-564)."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers.banded import block_tridiag_matvec

    Q = matern_precision(model, torch.float32, dev)
    n, k = Q.shape[0], SPMV_VECS
    x = torch.tensor(np.random.default_rng(0).normal(size=(k, n)), dtype=torch.float32, device=dev)

    def chain(mv):
        def run():
            v = x
            for _ in range(SPMV_CHAIN):
                y = mv(v)
                v = y / torch.linalg.matrix_norm(y)  # no readback inside the chain
            return v
        return run

    kernels.reset_launches()
    # ---- the multiply main path ----
    with torch.no_grad():
        ops = {"csr (K4)": Q.matvec, "block_tridiag (K13)": block_tridiag_matvec(Q),
               "bsr (K14)": kernels.bsr_from_sparse(Q).matvec}
        hot = kernels.hot_matvec(Q)
        picked = formulation(hot, Q)[0]
        ops["hot_matvec -> " + picked] = hot
        ms = {name: cuda_ms(chain(mv), SPMV_REPS, 1) / SPMV_CHAIN for name, mv in ops.items()}
        dev_ms = {name: kernel_device_ms(chain(mv), MULTIPLY_KERNEL_NAMES[formulation(mv, Q)[1]], SPMV_CHAIN)
                  for name, mv in ops.items()}
        one = {name: mv(x) for name, mv in ops.items()}
        ends = {name: chain(mv)() for name, mv in ops.items()}
    # one gradient through the BSR operator: d/d(values) and d/dx of sum(sin(Q x)), Q x of order one
    xs = x / Q.matvec(x).abs().max()
    data, xg = Q.data.clone().requires_grad_(), xs.clone().requires_grad_()
    from tpu_gmrf_torch.sparse.matrix import SparseMatrix
    torch.sin(kernels.bsr_from_sparse(SparseMatrix(data, Q.pattern)).matvec(xg)).sum().backward()
    torch.cuda.synchronize()
    counts = kernels.launches()
    # ---- end of the multiply main path ----
    launched(counts, MULTIPLY_KERNELS, "multiply")
    d2, x2 = Q.data.clone().requires_grad_(), xs.clone().requires_grad_()
    torch.sin(SparseMatrix(d2, Q.pattern).matvec(x2)).sum().backward()  # the same gradient through K4's autograd
    _, rel_d = rel_err((data.grad,), (d2.grad,))
    _, rel_x = rel_err((xg.grad,), (x2.grad,))
    log(f"  gradient of sum(sin(Q x)) through the BSR operator vs through K4: values {rel_d:.3e}, x {rel_x:.3e} "
        f"(tol 1e-4: float32 sums of terms of mixed sign, taken in two orders)")
    if not max(rel_d, rel_x) <= 1e-4:
        raise AssertionError("the BSR operator's gradient disagrees with K4's")
    payload = Q.nnz * 4 + 2 * n * k * 4
    mv13, plan14 = ops["block_tridiag (K13)"], kernels.bsr_from_sparse(Q).plan
    streamed = {"block_tridiag (K13)": (2 * mv13.D.shape[0] - 1) * mv13.D.shape[1] ** 2 * 4,
                "bsr (K14)": plan14.nblocks * plan14.bs**2 * 4}
    ref = one["csr (K4)"]
    for name in ops:
        _, rel = rel_err((one[name],), (ref,))
        _, rel_end = rel_err((ends[name],), (ends["csr (K4)"],))
        extra = ""
        if name in streamed:
            extra = (f", streams {streamed[name] / 1e6:.2f} MB of blocks: {streamed[name] / dev_ms[name] / 1e6:.1f} GB/s "
                     f"achieved by the kernel")
        log(f"  {name}: {ms[name]:.4f} ms per multiply of the chain (CUDA events, host gaps included), payload "
            f"{payload / ms[name] / 1e6:.2f} GB/s; the multiply kernel alone {dev_ms[name]:.4f} ms (torch.profiler), payload "
            f"{payload / dev_ms[name] / 1e6:.2f} GB/s{extra}; one multiply vs K4 rel {rel:.3e} (tol 1e-5), after "
            f"{SPMV_CHAIN} chained {rel_end:.3e} (tol 1e-3)")
        if not (rel <= 1e-5 and rel_end <= 1e-3):
            raise AssertionError(f"{name} disagrees with K4")
    log(bt_matvec_traffic(mv13.D.shape[0], mv13.D.shape[1], n, k, 4, dev_ms["block_tridiag (K13)"],
                          "its three kernels' device time per multiply, torch.profiler"))
    three = ("csr (K4)", "block_tridiag (K13)", "bsr (K14)")
    log(f"  hot_matvec picked {picked}; fastest chain {min(three, key=lambda nm: ms[nm])}, fastest kernel "
        f"{min(three, key=lambda nm: dev_ms[nm])}; speedup of the pick over K4 "
        f"{ms['csr (K4)'] / ms['hot_matvec -> ' + picked]:.3f}x by the chain, "
        f"{dev_ms['csr (K4)'] / dev_ms['hot_matvec -> ' + picked]:.3f}x by the kernel; the rule's rates from this run "
        f"(the bytes its cost model counts over the kernels' device time: K13's blocks; K14's blocks three times, "
        f"as the rule counts them): K13 {streamed['block_tridiag (K13)'] / dev_ms['block_tridiag (K13)'] * 1e3:.3e} B/s, "
        f"K14 {3 * streamed['bsr (K14)'] / dev_ms['bsr (K14)'] * 1e3:.3e} B/s on {card}")
    return counts


def cg_path(grid_q, dev, card):
    """Phase 13: CG at n=99856, once per formulation and once through hot_matvec."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers.banded import block_tridiag_matvec
    from tpu_gmrf_torch.solvers.cg import cg_solve, jacobi_preconditioner

    rng = np.random.default_rng(15)
    counts_all = None
    kernels.reset_launches()
    # ---- the CG main path ----
    for dtype in (torch.float64, torch.float32):
        Q = grid_q[dtype]
        n, tol = Q.shape[0], CG_TOL[dtype]
        spec = tg.SolverSpec(kind="cg", cg_tol=tol)
        b = torch.tensor(rng.normal(size=(CG_RHS, n)), dtype=dtype, device=dev)
        bnorm = torch.linalg.vector_norm(b, dim=-1)
        M = jacobi_preconditioner(Q)
        torch.cuda.reset_peak_memory_stats()
        mv13 = block_tridiag_matvec(Q)
        log(f"  {dtype_name(dtype)}: K13 storage s={mv13.D.shape[1]} K={mv13.D.shape[0]}, "
            f"{(mv13.D.numel() + mv13.E.numel()) * Q.data.element_size() / 1e9:.3f} GB of blocks; device memory in use "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        ops = {"csr (K4)": Q.matvec, "block_tridiag (K13)": mv13, "bsr (K14)": kernels.bsr_from_sparse(Q).matvec}
        sols = {}
        for name, mv in ops.items():
            run = lambda: cg_solve(mv, b, preconditioner=M, tol=tol, max_iter=spec.cg_max_iter)
            run()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, it, res = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            true_res = torch.linalg.vector_norm(b - Q.matvec(x), dim=-1) / bnorm  # recomputed with K4
            sols[name] = x
            idle = f", device idle {100 * device_idle(run)[1]:.1f}% (torch.profiler)" if dtype == torch.float64 else ""
            log(f"  {dtype_name(dtype)} CG on {name}: iterations per column {it.tolist()}, {wall / int(it.max()):.4f} ms "
                f"per iteration ({wall:.1f} ms), returned residual max {res.max().item():.3e}, recomputed with K4 max "
                f"{true_res.max().item():.3e} (limit {10 * tol:.0e}){idle}")
            if not (bool(torch.isfinite(x).all()) and true_res.max().item() <= 10 * tol):
                raise AssertionError(f"CG on {name} did not reach the tolerance")
        del mv13, ops
        f = tg.factorize(Q, spec)
        picked = formulation(f.matvec, Q)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = f.solve_info(b.T.contiguous())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        sols["factorize(kind='cg')"] = x.T
        log(f"  {dtype_name(dtype)} factorize(Q, SolverSpec(kind='cg')).solve, hot_matvec -> {picked}: iterations "
            f"{it.tolist()}, {wall / int(it.max()):.4f} ms per iteration, residual max {res.max().item():.3e}")
        ref = sols["csr (K4)"]
        for name, x in sols.items():
            _, rel = rel_err((x,), (ref,))
            if not rel <= 100 * tol:
                raise AssertionError(f"CG solution on {name} is {rel:.3e} from K4's (limit {100 * tol:.0e})")
        log(f"  {dtype_name(dtype)}: the solutions of the formulations agree within {100 * tol:.0e} of K4's")
        if dtype == torch.float64:
            g = tg.GMRF.from_information(b[0], Q, spec)
            r = torch.linalg.vector_norm(g.information_vector() - b[0]) / bnorm[0]
            log(f"  GMRF.from_information(b, Q, SolverSpec(kind='cg')): ‖Qμ − b‖/‖b‖ = {r.item():.3e}")
            if not r.item() <= 10 * tol:
                raise AssertionError("GMRF.from_information on the CG backend missed the tolerance")
            del g
        del f, sols
    counts_all = kernels.launches()
    # ---- end of the CG main path ----
    launched(counts_all, CG_KERNELS, "CG")
    return counts_all


def cg_matern_path(model, dev, card):
    """Phase 13b: CG on the stiff Matérn operator against the supernodal solve."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers.cg import cg_solve, full_cholesky_preconditioner

    Q = matern_precision(model, torch.float64, dev)
    n = Q.shape[0]
    b = torch.tensor(np.random.default_rng(16).normal(size=n), dtype=torch.float64, device=dev)
    kernels.reset_launches()
    # ---- the Matérn CG main path ----
    f = tg.factorize(Q, tg.SolverSpec(kind="cg"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xj, itj, resj = f.solve_info(b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    M = full_cholesky_preconditioner(Q, tg.SolverSpec(kind="supernodal"))
    xf, itf, resf = cg_solve(f.matvec, b, preconditioner=M, tol=f.tol, max_iter=f.max_iter)
    with torch.no_grad():
        ref = tg.factorize(Q, tg.SolverSpec(kind="supernodal")).solve(b)
    torch.cuda.synchronize()
    counts = kernels.launches()
    # ---- end of the Matérn CG main path ----
    picked, kernel = formulation(f.matvec, Q)
    launched(counts, CG_MATERN_KERNELS + (kernel,), "Matérn CG")
    _, rel_j = rel_err((xj,), (ref,))
    _, rel_f = rel_err((xf,), (ref,))
    log(f"  Jacobi CG on hot_matvec -> {picked} (cg_tol {f.tol:.0e}, cg_max_iter {f.max_iter}): {int(itj)} iterations, {wall / max(int(itj), 1):.4f} "
        f"ms per iteration, residual {resj.item():.3e}, {rel_j:.3e} from the supernodal solve "
        f"({'converged' if resj.item() <= f.tol else 'stopped at cg_max_iter, unconverged'})")
    log(f"  full Cholesky preconditioner: {int(itf)} iteration(s), residual {resf.item():.3e}, {rel_f:.3e} from the "
        f"supernodal solve (limit 1e-8)")
    # unconverged, the recurrence's residual wanders (CG lowers the error's Q-norm, not the residual): the
    # reference's CG on this operator also ends at cg_max_iter with a residual above 1, so only this is held
    converged = resj.item() <= f.tol
    if not (bool(torch.isfinite(xj).all()) and (converged or int(itj) == f.max_iter) and (not converged or rel_j <= 1e-4)):
        raise AssertionError("Jacobi CG on the Matérn operator went wrong")
    if not (int(itf) <= 2 and rel_f <= 1e-8):
        raise AssertionError("CG with the full Cholesky preconditioner did not converge at once")
    return counts


def rbmc_path(stats_model, sp_model, dev, card):
    """Phase 14: RBMC variances against selinv_diag; N(0, Q) draws by sqrt_matvec."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.linear_maps import CholeskySqrtMap
    from tpu_gmrf_torch.solvers.rbmc import _block_rbmc_plan, block_rbmc_var, rbmc_var

    gen = torch.Generator(device=dev).manual_seed(7)
    Q = matern_precision(stats_model, torch.float64, dev)
    Qs = matern_precision(sp_model, torch.float64, dev)
    t0 = time.perf_counter()
    blk_idx = _block_rbmc_plan(Qs.pattern, 1)[0]  # host Python, outside the timed region
    plan_s = time.perf_counter() - t0
    kernels.reset_launches()
    # ---- the RBMC main path ----
    with torch.no_grad():
        g = tg.GMRF.from_precision(torch.zeros(Q.shape[0], dtype=torch.float64, device=dev), Q,
                                   tg.SolverSpec(kind="supernodal"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = rbmc_var(g, gen, n_samples=RBMC_SAMPLES)
    torch.cuda.synchronize()
    rbmc_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        exact = g.var()
        gs = tg.GMRF.from_precision(torch.zeros(Qs.shape[0], dtype=torch.float64, device=dev), Qs,
                                    tg.SolverSpec(kind="supernodal"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vb = block_rbmc_var(gs, gen, n_samples=BLOCK_RBMC_SAMPLES)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        exact_s = gs.var()
        # N(0, Q) draws: w = L z through the square-root map of a banded and a supernodal factor
        z = torch.randn(Qs.shape[0], 4, generator=gen, dtype=torch.float64, device=dev)
        draws = {}
        for kind in ("banded", "supernodal"):
            f = tg.factorize(Qs, tg.SolverSpec(kind=kind))
            w = CholeskySqrtMap(f) @ z
            draws[kind] = ((w * f.solve(w)).sum(0) / (z * z).sum(0) - 1).abs().max().item()
    torch.cuda.synchronize()
    counts = kernels.launches()
    # ---- end of the RBMC main path ----
    launched(counts, RBMC_KERNELS, "RBMC")
    for name, est, ref, ms, S in (("rbmc_var n=%d" % Q.shape[0], v, exact, rbmc_ms, RBMC_SAMPLES),
                                  ("block_rbmc_var n=%d" % Qs.shape[0], vb, exact_s, block_ms, BLOCK_RBMC_SAMPLES)):
        err, tol = (est / ref - 1).abs(), rbmc_tol(S)
        log(f"  {name}, S={S}: {ms:.1f} ms; vs selinv_diag max rel {err.max().item():.4f} (tol {tol['max']:.3f}), mean rel "
            f"{err.mean().item():.4f} (tol {tol['mean']:.3f})")
        if not (bool(torch.isfinite(est).all()) and err.max().item() <= tol["max"] and err.mean().item() <= tol["mean"]):
            raise AssertionError(f"{name} is outside its Monte Carlo tolerance")
    log(f"  _block_rbmc_plan at n={Qs.shape[0]}: {plan_s:.2f} s of host Python, {blk_idx.shape[0]} blocks of width "
        f"{blk_idx.shape[1]} (not in the timed region)")
    log(f"  N(0, Q) draws w = L z by CholeskySqrtMap, n={Qs.shape[0]}, 4 columns: |wᵀQ⁻¹w / zᵀz − 1| banded "
        f"{draws['banded']:.3e}, supernodal {draws['supernodal']:.3e} (limit 1e-8)")
    if max(draws.values()) > 1e-8:
        raise AssertionError("sqrt_matvec draws fail wᵀ Q⁻¹ w = zᵀz")
    return counts


# ---- phases 3e, 15, 16: the GP-approximation and structure-learning path -------------------


def matern32(a, b, ell=KL_ELL):
    """Example 09's pairwise Matérn-3/2 kernel (examples/09_kl_approximation.py:30), in torch."""
    r = torch.sqrt(torch.sum((a - b) ** 2) + 1e-12)
    s = 3.0**0.5 * r / ell
    return (1.0 + s) * torch.exp(-s)


def matern32_cols(X: np.ndarray, probe) -> np.ndarray:
    """The kernel's columns K[:, probe] on the host (float64)."""
    d = np.sqrt(((X[:, None, :] - X[None, probe, :]) ** 2).sum(-1) + 1e-12)
    s = np.sqrt(3.0) * d / KL_ELL
    return (1.0 + s) * np.exp(-s)


def kl_problem(g: int) -> dict:
    """Example 09's points on the g x g grid, their reverse-maximin ordering,
    and the patterns and column buckets at ρ = 3 and 6, with host times."""
    from tpu_gmrf_torch.kl_cholesky import kl_buckets, reverse_maximin_ordering, sparsity_pattern_from_ordering

    X = grid_points(g)
    t0 = time.perf_counter()
    order, ell = reverse_maximin_ordering(X)
    host = {"ordering": time.perf_counter() - t0}
    pats = {}
    for rho in (KL_RHO, KL_RHO_WIDE):
        t0 = time.perf_counter()
        pat = sparsity_pattern_from_ordering(X, order, ell, rho)
        host[f"pattern rho={rho:g}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        buckets = kl_buckets(pat)
        host[f"buckets rho={rho:g}"] = time.perf_counter() - t0
        pats[rho] = (pat, buckets)
        sizes = {cap: len(cols) for cap, cols, *_ in buckets}
        log(f"  KL g={g} rho={rho:g}: n={len(X)}, nnz(L)={pat.nnz}, buckets {dict(sorted(sizes.items()))}")
    log(f"  KL g={g} host: " + ", ".join(f"{k} {v:.2f} s" for k, v in host.items()))
    return dict(X=X, order=order, ell=ell, pats=pats, host=host)


def kl_bucket_inputs(kp: dict, rho: float, dtype, dev):
    """Per bucket: (cap, Θ, count, entry_pos) on the card, Θ = cov_fn of the padded points."""
    from tpu_gmrf_torch.kl_cholesky import gram

    cov = gram(matern32)
    X = torch.tensor(kp["X"][kp["order"]], dtype=dtype, device=dev)
    out = []
    for cap, _, S_idx, entry_pos, count in kp["pats"][rho][1]:
        pts = X[torch.as_tensor(S_idx, device=dev)]
        out.append((cap, cov(pts, pts).contiguous(), torch.as_tensor(count, dtype=torch.int32, device=dev),
                    torch.as_tensor(entry_pos, dtype=torch.int32, device=dev)))
    return out


def kl_library(theta, count):
    """The yardstick beside K16: the reference's formulation (kl_cholesky.py:118-128) in two library calls
    on the padded bucket, torch.linalg.cholesky_ex of Θᵀ and solve_triangular of Uᵀ against e_last."""
    B, cap = theta.shape[:2]
    valid = torch.arange(cap, device=theta.device) >= (cap - count.long())[:, None]
    eye = torch.eye(cap, dtype=theta.dtype, device=theta.device)
    A = torch.where(valid[:, :, None] & valid[:, None, :], theta, 0.0) + KL_JITTER * eye \
        + (~valid).to(theta.dtype)[:, :, None] * eye
    e = theta.new_zeros(B, cap, 1)
    e[:, -1] = 1.0
    At = A.mT.contiguous()

    def run():
        L, _ = torch.linalg.cholesky_ex(At)
        return torch.linalg.solve_triangular(L.mT, e, upper=True)
    return run


def check_kl_buckets(label, inputs, nnz: int, dtype, results=None, reps: int = 10):
    """K16 against its plain version (and the library yardstick) on every bucket of `inputs`."""
    from tpu_gmrf_torch import kernels

    el, tot = torch.finfo(dtype).bits // 8, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    err = scale = 0.0
    nans = [0, 0]
    for cap, theta, count, pos in inputs:
        out_k, out_p = theta.new_zeros(nnz), theta.new_zeros(nnz)
        kernels.kl_columns(theta, count, pos, KL_JITTER, out_k)
        kernels.kl_columns_plain(theta, count, pos, KL_JITTER, out_p)
        torch.cuda.synchronize()
        sel = pos[pos >= 0].long()
        k, p = out_k[sel], out_p[sel]
        if not torch.equal(k.isnan(), p.isnan()):
            raise AssertionError(f"kl_columns {label} cap={cap}: NaN masks of kernel and plain differ")
        fin = ~p.isnan()
        nans[0] += int(k.isnan().sum())
        b_err = float((k[fin] - p[fin]).abs().max()) if bool(fin.any()) else 0.0
        err, scale = max(err, b_err), max(scale, float(p[fin].abs().max()) if bool(fin.any()) else 0.0)
        nans[1] += broken_columns(k, count)
        N = count.double()
        flops = float((N**3 / 3 + N**2).sum())
        nbytes = el * float((N**2 + N).sum()) + 4 * (count.numel() * (cap + 1))
        ms = cuda_ms(lambda: kernels.kl_columns(theta, count, pos, KL_JITTER, out_k), reps, 2)
        pms = cuda_ms(lambda: kernels.kl_columns_plain(theta, count, pos, KL_JITTER, out_p), 2, 1)
        lms = cuda_ms(kl_library(theta, count), 3, 1)
        bnd = bound(flops, nbytes, dtype)
        log(f"    cap={cap} B={count.numel()} ({kernels.kl_path(cap, dtype)} path): max_abs_err={b_err:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={pms:.3f} library_ms={lms:.3f} bound_ms={bnd['bound_ms']:.5f} "
            f"({bnd['bound_by']}), NaN entries {int(k.isnan().sum())}")
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("flops", flops), ("bytes", nbytes)):
            tot[key] += v
    rel, tol = err / max(scale, 1e-300), SN_TOL[dtype]["kl_columns"]
    bnd = bound(tot["flops"], tot["bytes"], dtype)
    log(f"  kl_columns {label} {dtype_name(dtype)}: max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:.0e}), NaN "
        f"entries {nans[0]} (kernel and plain masks equal), columns broken down {nans[1]}; all buckets: "
        f"kernel_ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.3f} library_ms={tot['library_ms']:.3f} (two library "
        f"calls per bucket) bound_ms={bnd['bound_ms']:.5f} ({bnd['bound_by']})")
    if not rel <= tol:
        raise AssertionError(f"kl_columns {label}: kernel disagrees with its plain version ({rel:.3e})")
    if results is not None:
        results["kl_columns"] = {"max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                                 "library_ms": tot["library_ms"], **bnd, "dtype": dtype_name(dtype), "shape": label}


def broken_columns(vals, count) -> int:
    """How many columns of a bucket have NaN values (the flat `vals` in column order)."""
    col = torch.repeat_interleave(torch.arange(count.numel(), device=vals.device), count.long())
    return int(torch.unique(col[vals.isnan()]).numel())


def glasso_problem(n: int, m: int, density: float, extra: int = 0):
    """Example 10's generator (examples/10_graphical_lasso.py:26-33): the sparse truth A, Q_t, and
    m + extra samples of N(0, Q_t⁻¹)."""
    import scipy.linalg
    import scipy.sparse as sp

    rng = np.random.default_rng(42)
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(7))
    A = A + A.T
    A = A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)
    Qt = A.toarray()
    L = np.linalg.cholesky(Qt)
    X = scipy.linalg.solve_triangular(L.T, rng.normal(size=(n, m + extra)), lower=False).T
    return A.tocsr(), Qt, X


def glasso_host(X: np.ndarray, lam) -> dict:
    """The host half of graphical_lasso, timed: soft-thresholded covariance, chordal cover, plans."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.graphical_lasso import chordal_cover, embed_plan, soft_threshold_cov

    host = {}
    t0 = time.perf_counter()
    C, pat, mu = soft_threshold_cov(X, lam)
    host["covariance"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cover, cliques, seps = chordal_cover(pat)
    host["chordal_cover"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sets = list(cliques) + list(seps)
    blocks = kernels.BlockSets(sets, [1.0] * len(cliques) + [-1.0] * len(seps))
    pos = embed_plan(cover, sets)
    plan = kernels.SegPlan.grouped(pos, np.arange(pos.size), cover.nnz)
    host["plans"] = time.perf_counter() - t0
    return dict(C=C, pat=pat, mu=mu, cover=cover, cliques=cliques, seps=seps, blocks=blocks, plan=plan, host=host)


def block_inv_library(C, blocks):
    """The yardstick beside K17: the reference's formulation, torch.linalg.inv per size bucket of the
    gathered blocks (one gather and one inverse per bucket)."""
    by_size: dict = {}
    for b, s in enumerate(blocks.sizes):
        by_size.setdefault(int(s), []).append(b)
    idx = [torch.as_tensor(np.stack([blocks.idx[blocks.ptr[b]:blocks.ptr[b + 1]] for b in group]),
                           dtype=torch.long, device=C.device) for group in by_size.values()]

    def run():
        return [torch.linalg.inv(C[i[:, :, None], i[:, None, :]]) for i in idx]
    return run, len(idx)


def check_block_inv(label, C, blocks, dtype, results=None):
    """K17 against its plain version and the library yardstick."""
    from tpu_gmrf_torch import kernels

    got, ref = kernels.block_inv(C, blocks), kernels.block_inv_plain(C, blocks)
    torch.cuda.synchronize()
    if not torch.equal(got.isnan(), ref.isnan()):
        raise AssertionError(f"block_inv {label}: NaN masks of kernel and plain differ")
    el, s = torch.finfo(dtype).bits // 8, blocks.sizes.astype(float)
    flops = float((2 * s**3).sum())
    nbytes = el * 2 * float((s**2).sum()) + 4 * float(s.sum()) + (24 + el) * len(blocks)
    lib, nbuckets = block_inv_library(C, blocks)
    check(f"block_inv {label} ({len(blocks)} sets, sizes {int(s.min())}-{int(s.max())}, "
          f"{int((blocks.sizes > kernels.block_inv_smem_max(dtype)).sum())} on the global path)", dtype,
          got, ref, "block_inv", results if results is not None else {}, cuda_ms(lambda: kernels.block_inv(C, blocks), 10),
          cuda_ms(lambda: kernels.block_inv_plain(C, blocks), 2, 1), cost=(flops, nbytes), library_ms=cuda_ms(lib, 3, 1),
          shape=label, extra=f" (library: torch.linalg.inv per size bucket, {nbuckets} buckets)")


def check_rect_spmv(dev):
    """K4 on a 500 x 14,058 selection matrix (the observation matrix of linear_condition) and its
    transpose, B ∈ {1, 8}, against its plain version and CSR torch.sparse.mm."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern
    from tpu_gmrf_torch.sparse.matrix import _csr

    rng = np.random.default_rng(17)
    n, m = 14058, 500
    cols = rng.choice(n, m, replace=False)
    for dtype in (torch.float64, torch.float32):
        el = torch.finfo(dtype).bits // 8
        A = SparseMatrix(torch.ones(m, dtype=dtype, device=dev), SparsePattern(np.arange(m), cols, (m, n)))
        for label, M in (("A", A), ("A^T", A.T)):
            rp, col = _csr(M.pattern, dev)
            data, (nr, nc) = M.data.contiguous(), M.shape
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                lib = torch.sparse_csr_tensor(rp.long(), col.long(), data, size=M.shape)
            for B in (1, 8):
                x = torch.tensor(rng.normal(size=(B, nc)), dtype=dtype, device=dev)
                xt = x.T.contiguous()
                path = kernels.spmv_path(nr, B, dtype, nc)
                y = kernels.csr_spmv(rp, col, data, x)[0]
                _, rel = rel_err((y,), (torch.sparse.mm(lib, xt).T,))
                if not rel <= SN_TOL[dtype]["csr_spmv"]:
                    raise AssertionError(f"rectangular csr_spmv disagrees with CSR torch.sparse.mm ({rel:.3e})")
                check(f"csr_spmv rectangular {label} {nr}x{nc} B={B} ({path} path)", dtype, y,
                      kernels.csr_spmv_plain(rp, col, data, x)[0], "csr_spmv", {},
                      cuda_ms(lambda: kernels.csr_spmv(rp, col, data, x)),
                      cuda_ms(lambda: kernels.csr_spmv_plain(rp, col, data, x)),
                      cost=(2 * B * M.nnz, 4 * (nr + 1 + M.nnz) + el * (M.nnz + B * (nr + nc))),
                      library_ms=cuda_ms(lambda: torch.sparse.mm(lib, xt)))


def check_gp_kernels(kp: dict, gp: dict, dev) -> dict:
    """Phase 3e: K16 on the n=10,000 buckets (ρ = 3 and 6) and one bucket beyond shared memory, K17
    on the n=1000 glasso sets plus one set of 200 (global path), rectangular K4; f64 and f32."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.kl_cholesky import gram

    results = {}
    nnz = {rho: kp["pats"][rho][0].nnz for rho in (KL_RHO, KL_RHO_WIDE)}
    rng = np.random.default_rng(18)
    for dtype in (torch.float64, torch.float32):
        for rho in (KL_RHO, KL_RHO_WIDE):
            t0 = time.perf_counter()
            inputs = kl_bucket_inputs(kp, rho, dtype, dev)
            torch.cuda.synchronize()
            log(f"  {dtype_name(dtype)} rho={rho:g}: cov_fn over the buckets {time.perf_counter() - t0:.3f} s (wall)")
            label = f"n={len(kp['X'])} rho={rho:g}"
            check_kl_buckets(label, inputs, nnz[rho], dtype,
                             results if (dtype == torch.float64 and rho == KL_RHO) else None)
            del inputs
        # beyond shared memory: one bucket of cap 256 (columns of 256, 256, 200 and 129 rows)
        cap, count = 256, np.array([256, 256, 200, 129])
        pts = torch.tensor(rng.uniform(size=(len(count), cap, 2)), dtype=dtype, device=dev)
        pos = np.full((len(count), cap), -1)
        nxt = 0
        for b, N in enumerate(count):
            pos[b, cap - N:] = np.arange(nxt, nxt + N)
            nxt += N
        theta = gram(matern32)(pts, pts)
        check_kl_buckets(f"synthetic cap={cap} ({'global' if cap > 168 else 'shared'} path)",
                         [(cap, theta, torch.tensor(count, dtype=torch.int32, device=dev),
                           torch.tensor(pos, dtype=torch.int32, device=dev))], nxt, dtype, reps=3)
        # K17: the n=1000 graphical lasso's cliques (+1) and separators (-1); then with a set of 200
        C = torch.tensor(gp["C"], dtype=dtype, device=dev)
        check_block_inv(f"n={len(gp['mu'])} glasso", C, gp["blocks"], dtype,
                        results if dtype == torch.float64 else None)
        sets = list(gp["cliques"]) + list(gp["seps"]) + [np.sort(rng.choice(len(gp["mu"]), 200, replace=False))]
        big = kernels.BlockSets(sets, [1.0] * len(gp["cliques"]) + [-1.0] * (len(gp["seps"]) + 1))
        check_block_inv(f"n={len(gp['mu'])} glasso + one set of 200", C, big, dtype)
    check_rect_spmv(dev)
    return results


def kl_path(kp: dict, dev, card):
    """Phase 15: example 09 at g=30 (auto -> dense) with a sum-to-zero ConstrainedGMRF, then at
    g=100 (auto -> supernodal) with 50 observations; against the plain path."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.kl_cholesky import gram, sparse_approximate_cholesky
    from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern

    cov = gram(matern32)
    X30, X100 = grid_points(KL_GRID_SMALL), kp["X"]
    n30, n100 = len(X30), len(X100)
    rng = np.random.default_rng(123)  # example 09's draws: 12 probe columns, then 5 observations
    probe30 = rng.integers(0, n30, size=12)
    obs30 = rng.integers(0, n30, size=5)
    y30 = np.sin(4 * X30[obs30, 0]) * np.cos(3 * X30[obs30, 1])
    rng = np.random.default_rng(124)
    probe100 = rng.integers(0, n100, size=12)
    obs100 = np.sort(rng.choice(n100, KL_OBS, replace=False))
    y100 = np.sin(4 * X100[obs100, 0]) * np.cos(3 * X100[obs100, 1])
    x30 = np.random.default_rng(125).normal(size=n30)

    def selection(obs, n, where):
        return SparseMatrix(torch.ones(len(obs), dtype=torch.float64, device=where),
                            SparsePattern(np.arange(len(obs)), obs, (len(obs), n)))

    def probe_cols(g, probe):
        E = torch.zeros(g.n, len(probe), dtype=torch.float64, device=g.Q.device)
        E[torch.as_tensor(probe), torch.arange(len(probe))] = 1.0
        return g.factor.solve(E)

    def small(where):
        """Example 09 at g=30, a sum-to-zero constraint, both conditioned on the 5 observations."""
        g = tg.approximate_gmrf_kl(torch.tensor(X30, device=where), cov, rho=KL_RHO, jitter=KL_JITTER)
        post = tg.linear_condition(g, y30, Q_eps=1e4, A=selection(obs30, n30, where))
        c = tg.ConstrainedGMRF.create(g, np.ones((1, n30)), np.zeros(1))
        cpost = tg.linear_condition(c, y30, Q_eps=1e4, A=selection(obs30, n30, where))
        xt = torch.tensor(x30, device=where)
        return dict(g=g, sig=probe_cols(g, probe30), mean=post.mean, var=post.var(), logdet=g.logdet_precision(),
                    cmean=cpost.mean, cvar=cpost.var(), clp=cpost.logpdf(xt), gvar=g.var())

    kernels.reset_launches()
    # ---- the KL main path ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r30 = small(dev)
    torch.cuda.synchronize()
    s30 = time.perf_counter() - t0
    t0 = time.perf_counter()
    g100 = tg.approximate_gmrf_kl(X100, cov, rho=KL_RHO, jitter=KL_JITTER)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sig100 = probe_cols(g100, probe100)
    var100, logdet100 = g100.var(), g100.logdet_precision()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post100 = tg.linear_condition(g100, y100, Q_eps=1e4, A=selection(obs100, n100, dev))
    mean100, pvar100 = post100.mean, post100.var()
    torch.cuda.synchronize()
    cond_s = time.perf_counter() - t0
    counts = kernels.launches()
    # ---- end of the KL main path ----
    launched(counts, KL_KERNELS, "KL")
    kinds = (tg.SolverSpec().resolve(r30["g"].Q.pattern).kind, tg.SolverSpec().resolve(g100.Q.pattern).kind)
    log(f"  g={KL_GRID_SMALL}: n={n30}, nnz(Q)={r30['g'].Q.nnz}, auto -> {kinds[0]}; build, 12 probe solves, two "
        f"linear_conditions, a ConstrainedGMRF and their statistics {s30:.2f} s (wall)")
    log(f"  g={KL_GRID}: n={n100}, nnz(Q)={g100.Q.nnz}, auto -> {kinds[1]}; approximate_gmrf_kl {build_s:.2f} s "
        f"(wall; host ordering {kp['host']['ordering']:.2f} s, pattern {kp['host']['pattern rho=3']:.2f} s, "
        f"buckets {kp['host']['buckets rho=3']:.2f} s of it), linear_condition on {KL_OBS} observations + var "
        f"{cond_s:.2f} s")
    if kinds != ("dense", "supernodal"):
        raise AssertionError(f"auto resolved to {kinds}, expected dense at n={n30} and supernodal at n={n100}")
    # example 09's acceptance checks, at both sizes
    for label, X, r, probe, obs, y, mean, var in (
            (f"g={KL_GRID_SMALL}", X30, r30["sig"], probe30, obs30, y30, r30["mean"], r30["var"]),
            (f"g={KL_GRID}", X100, sig100, probe100, obs100, y100, mean100, pvar100)):
        err = float(np.abs(r.cpu().numpy() - matern32_cols(X, probe)).max())
        fit = float(np.abs(mean.cpu().numpy()[obs] - y).max())
        v = var.cpu().numpy()
        log(f"  {label}: max |Σ - K| on 12 probe columns {err:.4f} (limit 0.08); conditional mean at the {len(obs)} "
            f"observations within {fit:.2e} (limit 0.02); var at the observations max {v[obs].max():.3e} < median "
            f"{np.median(v):.3e}")
        if not (err < 0.08 and fit < 0.02 and v[obs].max() < np.median(v)):
            raise AssertionError(f"example 09's checks fail at {label}")
    if abs(float(r30["cmean"].sum())) > 1e-8:
        raise AssertionError("the conditioned ConstrainedGMRF's mean does not sum to zero")
    # against the plain path: g=30 whole on CPU tensors; g=100: Q's data on CPU tensors, logdet and var on
    # the plain versions on the card
    p30 = small(torch.device("cpu"))
    rows = []
    for key, tol_key in (("logdet", "logdet"), ("gvar", "stat"), ("mean", "stat"), ("var", "stat"),
                         ("cmean", "stat"), ("cvar", "stat"), ("clp", "stat")):
        _, rel = rel_err((r30[key].cpu(),), (p30[key],))
        rows.append(f"{key} {rel:.2e}")
        if not rel <= PATH_TOL[tol_key]:
            raise AssertionError(f"KL g=30 {key}: the kernel path is {rel:.3e} from the plain path")
    _, rel = rel_err((r30["g"].Q.data.cpu(),), (p30["g"].Q.data,))
    if not rel <= PATH_TOL["data"]:
        raise AssertionError(f"KL g=30 Q: the kernel path is {rel:.3e} from the plain path")
    log(f"  g={KL_GRID_SMALL} kernels vs the plain path on CPU tensors: Q {rel:.2e}, {', '.join(rows)} "
        f"(limits {PATH_TOL}); constrained logpdf {float(r30['clp']):.6f}")
    pat, order = kp["pats"][KL_RHO][0], kp["order"]
    t0 = time.perf_counter()
    Lp = sparse_approximate_cholesky(torch.tensor(X100), cov, pat, order, KL_JITTER)
    Qp = Lp @ Lp.T
    cpu_s = time.perf_counter() - t0
    pat_q = SparsePattern(order[Qp.pattern.rows], order[Qp.pattern.cols], (n100, n100))
    if pat_q != g100.Q.pattern:
        raise AssertionError("KL g=100: Q's pattern differs from the plain path's")
    _, rel_q = rel_err((g100.Q.data.cpu(),), (Qp.data[torch.as_tensor(pat_q.sort_order)],))
    fp = plain_factorize(g100.Q)
    _, rel_ld = rel_err((logdet100,), (fp.logdet(),))
    _, rel_v = rel_err((var100,), (fp.selinv_diag(),))
    log(f"  g={KL_GRID} kernels vs plain: Q's data {rel_q:.2e} (CPU tensors, {cpu_s:.2f} s), logdet {rel_ld:.2e} "
        f"({float(logdet100):.6f}), var {rel_v:.2e} (plain supernodal on the card)")
    if not (rel_q <= PATH_TOL["data"] and rel_ld <= PATH_TOL["logdet"] and rel_v <= PATH_TOL["stat"]):
        raise AssertionError("KL g=100: the kernel path disagrees with the plain path")
    # host time the path paid for the auto resolution (the banded plan and the supernodal symbolic
    # summary, with its AMD ordering) and the supernodal plan: recomputed under another max_width,
    # since the path's own are cached
    from tpu_gmrf_torch.solvers.base import _large_sparse_kind
    from tpu_gmrf_torch.solvers.supernodal import supernodal_plan

    t0 = time.perf_counter()
    _large_sparse_kind(g100.Q.pattern, tg.SolverSpec(max_width=2047))
    resolve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    supernodal_plan(g100.Q.pattern, 2047, "auto")
    plan_s = time.perf_counter() - t0
    log(f"  g={KL_GRID} host steps: ordering {kp['host']['ordering']:.2f} s, pattern {kp['host']['pattern rho=3']:.2f} s, "
        f"buckets {kp['host']['buckets rho=3']:.2f} s (phase 3e), auto resolution (banded plan, supernodal "
        f"symbolic summary) {resolve_s:.2f} s, supernodal plan {plan_s:.2f} s")
    # device time of the steps at g=100 (CUDA events; K16's own per bucket is phase 3e's)
    Xd = torch.tensor(X100[order], device=dev)
    buckets = kp["pats"][KL_RHO][1]
    pts = [Xd[torch.as_tensor(S, device=dev)] for _, _, S, _, _ in buckets]
    cov_ms = cuda_ms(lambda: [cov(p_, p_) for p_ in pts], 3, 1)
    L = sparse_approximate_cholesky(X100, cov, pat, order, KL_JITTER)
    spgemm_ms = cuda_ms(lambda: L @ L.T, 5, 1)
    fact_ms = cuda_ms(lambda: tg.factorize(g100.Q), 3, 1)
    var_ms = cuda_ms(g100.var, 3, 1)
    log(f"  g={KL_GRID} device steps: cov_fn over the {len(buckets)} buckets {cov_ms:.3f} ms, L Lᵀ (K5) "
        f"{spgemm_ms:.3f} ms, supernodal factorization {fact_ms:.3f} ms, var (Takahashi) {var_ms:.3f} ms "
        f"on {card}")
    return counts


def glasso_path(gp: dict, held_out: np.ndarray, dev, card):
    """Phase 16: example 10 at n=200 (λ and the restricted Λ) with its checks, then n=1000; against
    the plain versions on the card."""
    import scipy.sparse as sp

    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import dense as td
    from tpu_gmrf_torch.sparse import SparseMatrix
    from tpu_gmrf_torch.sparse.matrix import _csr

    A200, Qt200, X200 = glasso_problem(GL_SMALL["n"], GL_SMALL["m"], GL_SMALL["density"])
    n200 = GL_SMALL["n"]
    Lam = sp.csr_matrix((np.full(A200.nnz, GL_SMALL["lam"]), A200.nonzero()), shape=(n200, n200))
    X1k = gp["X"]
    kernels.reset_launches()
    # ---- the graphical-lasso main path ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g200 = tg.graphical_lasso(X200, threshold=GL_SMALL["lam"])
    g200r = tg.graphical_lasso(X200, threshold=Lam)
    torch.cuda.synchronize()
    s200 = time.perf_counter() - t0
    t0 = time.perf_counter()
    g1k = tg.graphical_lasso(X1k, threshold=GL["lam"])
    torch.cuda.synchronize()
    s1k = time.perf_counter() - t0
    lp = g1k.logpdf(torch.tensor(held_out, device=dev))
    torch.cuda.synchronize()
    counts = kernels.launches()
    # ---- end of the graphical-lasso main path ----
    launched(counts, GLASSO_KERNELS, "graphical lasso")
    # example 10's acceptance checks
    Qe, Qr = g200.Q.todense().cpu().numpy(), g200r.Q.todense().cpu().numpy()
    eig, eig_r = np.linalg.eigvalsh(Qe).min(), np.linalg.eigvalsh(Qr).min()
    rel = np.linalg.norm(Qe - Qt200) / np.linalg.norm(Qt200)
    rel_r = np.linalg.norm(Qr - Qt200) / np.linalg.norm(Qt200)
    dens = (Qe != 0).mean()
    log(f"  n={n200}, m={GL_SMALL['m']} (two graphical_lasso calls {s200:.2f} s): λ: min eig {eig:.4f} (> 0), rel "
        f"Frobenius {rel:.4f} (< 0.35), density {dens:.4f} (< 0.25); restricted Λ: min eig {eig_r:.4f}, rel "
        f"Frobenius {rel_r:.4f} (≤ {rel:.4f})")
    if not (eig > 0 and rel < 0.35 and dens < 0.25 and eig_r > 0 and rel_r <= rel + 1e-9):
        raise AssertionError("example 10's checks fail")
    n = len(gp["mu"])
    Q1 = g1k.Q.todense().cpu().numpy()
    eig1 = np.linalg.eigvalsh(Q1).min()
    rel1 = np.linalg.norm(Q1 - gp["Qt"]) / np.linalg.norm(gp["Qt"])
    sizes = np.array([len(c) for c in gp["cliques"]])
    log(f"  n={n}, m={GL['m']}: graphical_lasso {s1k:.2f} s (wall; host covariance {gp['host']['covariance']:.2f} s, "
        f"chordal_cover {gp['host']['chordal_cover']:.2f} s, plans {gp['host']['plans']:.2f} s of it); "
        f"{len(gp['cliques'])} cliques (mean {sizes.mean():.1f}, max {sizes.max()}), {len(gp['seps'])} separators, "
        f"{len(set(sizes.tolist()) | set(len(s) for s in gp['seps']))} distinct sizes, cover nnz {gp['cover'].nnz}; "
        f"min eig {eig1:.4f}, rel Frobenius to the truth {rel1:.4f}, held-out logpdf mean {float(lp.mean()):.4f}")
    if not (eig1 > 0 and bool(torch.isfinite(lp).all())):
        raise AssertionError("the n=1000 graphical lasso is not positive definite or its logpdf is not finite")
    # the plain path on the card: K17, K5, K9 and K4's plain versions on the same inputs
    C = torch.tensor(gp["C"], device=dev)
    buf = kernels.block_inv_plain(C, gp["blocks"])
    Qp = SparseMatrix(kernels.gather_segsum_plain(gp["plan"], buf[None])[0], gp["cover"]).symmetrize()
    _, _, _, logdet_p = kernels.dense_chol_plain(Qp.data[None].contiguous(), td._tables(Qp.pattern))
    rp, col = _csr(Qp.pattern, dev)
    xc = torch.tensor(held_out, device=dev) - torch.tensor(gp["mu"], device=dev)
    quad_p = kernels.csr_spmv_plain(rp, col, Qp.data, xc, quad=True)[1]
    lp_p = -0.5 * (n * 1.8378770664093453 - logdet_p[0] + quad_p)
    _, rel_q = rel_err((g1k.Q.data,), (Qp.data,))
    _, rel_ld = rel_err((g1k.logdet_precision(),), (logdet_p[0],))
    _, rel_lp = rel_err((lp,), (lp_p,))
    log(f"  n={n} kernels vs plain (on the card): Q {rel_q:.2e}, logdet {rel_ld:.2e}, held-out logpdf {rel_lp:.2e} "
        f"(limits {PATH_TOL['data']:.0e}, {PATH_TOL['logdet']:.0e}, {PATH_TOL['stat']:.0e})")
    if not (rel_q <= PATH_TOL["data"] and rel_ld <= PATH_TOL["logdet"] and rel_lp <= PATH_TOL["stat"]):
        raise AssertionError("the n=1000 graphical lasso disagrees with its plain path")
    sb = kernels.block_inv(C, gp["blocks"])
    inv_ms = cuda_ms(lambda: kernels.block_inv(C, gp["blocks"]), 10)
    embed_ms = cuda_ms(lambda: kernels.gather_segsum(gp["plan"], sb[None]), 10)
    fact_ms = cuda_ms(lambda: tg.factorize(g1k.Q), 5, 1)
    log(f"  n={n} device steps: block_inv (K17) {inv_ms:.3f} ms, signed sums into the cover (K5) {embed_ms:.3f} ms, "
        f"dense factorization (K9) {fact_ms:.3f} ms on {card}")
    return counts


# ---- phases 3f, 17, 18: the SPIKE solve and fault 3.1 ----------------------------------------


def spike_system(dn_model, dtype, dev):
    """Phase 17's blocks: diag (Nt, ns, ns), sub (Nt-1, ns, ns) of Q_t ⊗ Q_s and b (Nt, ns)."""
    from tpu_gmrf_torch import AR1Model

    one = torch.ones((), dtype=torch.float64, device=dev)
    Qt = AR1Model(SPIKE_NT).precision(one, SPIKE_RHO * one).todense()
    Qs = matern_precision(dn_model, torch.float64, dev).todense()
    a, c = torch.diagonal(Qt), torch.diagonal(Qt, -1)
    diag, sub = a[:, None, None] * Qs, c[:, None, None] * Qs
    b = torch.tensor(np.random.default_rng(17).normal(size=(SPIKE_NT, Qs.shape[0])), device=dev)
    return diag.to(dtype), sub.to(dtype), b.to(dtype)


def ex12_system(dev):
    """Example 12 part 3's inputs, as the example draws them: float32 numpy."""
    Nt, ns = 4 * EX12_P, EX12_NS
    rng = np.random.default_rng(EX12_SEED)
    diag = rng.normal(size=(Nt, ns, ns)).astype(np.float32)
    diag = diag @ np.swapaxes(diag, -1, -2) + (ns + 1.0) * np.eye(ns, dtype=np.float32)
    sub = (0.05 * rng.normal(size=(Nt - 1, ns, ns))).astype(np.float32)
    b = rng.normal(size=(Nt, ns)).astype(np.float32)
    return diag, sub, b


def dense_block_tridiag(diag, sub) -> np.ndarray:
    Nt, ns = diag.shape[0], diag.shape[1]
    Q = np.zeros((Nt * ns, Nt * ns))
    for t in range(Nt):
        Q[t * ns:(t + 1) * ns, t * ns:(t + 1) * ns] = diag[t]
    for t in range(Nt - 1):
        Q[(t + 1) * ns:(t + 2) * ns, t * ns:(t + 1) * ns] = sub[t]
        Q[t * ns:(t + 1) * ns, (t + 1) * ns:(t + 2) * ns] = sub[t].T
    return Q


def spike_kernel_calls(diag, sub, b, P: int) -> dict:
    """The arguments one in-process SPIKE solve gives K11-blocks, K12-blocks and K18 (the first call of each),
    recorded by wrapping them; the solve runs on the kernels."""
    from unittest import mock

    from tpu_gmrf_torch.parallel import pbtridiag as pb

    seen = {}

    def recording(name):
        fn = getattr(pb, name)

        def wrapper(*args, **kw):
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)

        return mock.patch.object(pb, name, wrapper)

    with torch.no_grad(), recording("bt_factor_blocks"), recording("bt_trsv_blocks"), recording("spike_reduced"):
        pb._pbtridiag_chunks(diag, sub, b, P)
    return seen


def check_spike_kernels(label, diag, sub, b, P: int, dtype, results, reps: int = REPS, sweep: bool = False):
    """Phase 3f: K11's and K12's block entries and K18 on the arguments the SPIKE solve gives them, against
    their plain versions and the library yardstick (`cholesky_ex` + `solve_triangular` on the same blocks);
    K12's at k = 1 (the gradient's re-solve) and the solve's own k, and with `sweep` also at 8, 9 and 64."""
    from tpu_gmrf_torch import kernels

    calls = spike_kernel_calls(diag, sub, b, P)
    el = diag.element_size()
    (D, E), _ = calls["bt_factor_blocks"]
    B, K, s = D.shape[0], D.shape[1], D.shape[-1]
    got, ref = kernels.bt_factor_blocks(D, E), kernels.bt_factor_blocks_plain(D, E)
    L = got[0][:, :, :s]
    A = (L @ L.mT).reshape(B * K, s, s)  # D_k − M_{k−1}M_{k−1}ᵀ, the blocks K11 factors
    Lm, Em = L[:, : K - 1].reshape(-1, s, s), E.reshape(-1, s, s)
    check(f"bt_factor_blocks {label}", dtype, got, ref, "bt_factor_blocks", results,
          cuda_ms(lambda: kernels.bt_factor_blocks(D, E), reps, 1),
          cuda_ms(lambda: kernels.bt_factor_blocks_plain(D, E), reps, 1),
          cost=(B * sum(s**3 / 3 + (2 * s**3 if k < K - 1 else 0) for k in range(K)),
                el * B * ((2 * K - 1) * s * s + K * 2 * s * s + 1)),
          library_ms=cuda_ms(lambda: (torch.linalg.cholesky_ex(A), torch.linalg.solve_triangular(Lm, Em.mT, upper=False)),
                             reps, 1),
          shape=f"B={B} K={K} s={s}", extra=" (library: cholesky_ex of the K blocks + solve_triangular for M)")
    (Pf, R), _ = calls["bt_trsv_blocks"]
    k = R.shape[-1]
    Lb = Pf[:, :, :s].reshape(B * K, s, s)
    # 8 and 9 straddle the kernel's two column tiles (8 and 64 right-hand sides); the row of `results` is k's
    ks = (1, 8, 9, 64, k) if sweep else (1, k)
    for kk in ks:
        Rk = R[..., :kk].contiguous() if kk < k else R
        Rb = Rk.reshape(B * K, s, kk)
        check(f"bt_trsv_blocks {label} k={kk}", dtype, kernels.bt_trsv_blocks(Pf, Rk),
              kernels.bt_trsv_blocks_plain(Pf, Rk), "bt_trsv_blocks", results if kk == k else {},
              cuda_ms(lambda: kernels.bt_trsv_blocks(Pf, Rk), reps, 1),
              cuda_ms(lambda: kernels.bt_trsv_blocks_plain(Pf, Rk), reps, 1),
              cost=(B * kk * (2 * K * s * s + 4 * (K - 1) * s * s),
                    el * (B * (K * s * (s + 1) // 2 + (K - 1) * s * s) + 2 * B * K * s * kk)),
              library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
                  Lb.mT, torch.linalg.solve_triangular(Lb, Rb, upper=False), upper=True), reps, 1),
              shape=f"B={B} K={K} s={s} k={kk}", extra=" (library: solve_triangular both ways on each block)")
    (Al, Be, Ga, r), _ = calls["spike_reduced"]
    Pn, ns, kr = r.shape
    gs, gl, gL = kernels.spike_reduced(Al, Be, Ga, r)
    ps, pl, _ = kernels.spike_reduced_plain(Al, Be, Ga, r)
    Lc = torch.linalg.cholesky_ex(Be)[0]
    check(f"spike_reduced {label}", dtype, (gs, gl), (ps, pl), "spike_reduced", results,
          cuda_ms(lambda: kernels.spike_reduced(Al, Be, Ga, r), reps, 1),
          cuda_ms(lambda: kernels.spike_reduced_plain(Al, Be, Ga, r), reps, 1),
          cost=(Pn * (13 * ns**3 / 3 + 8 * ns * ns * kr), el * (4 * Pn * ns * ns + 2 * Pn * ns * kr + 1)),
          library_ms=cuda_ms(lambda: (torch.linalg.cholesky_ex(Be), torch.linalg.solve_triangular(
              Lc, torch.cat([Al.mT, Ga, r], -1), upper=False)), reps, 1),
          shape=f"P={Pn} ns={ns} k={kr}", extra=" (library: cholesky_ex of the P blocks + one solve_triangular)")
    r2 = torch.ones_like(r)
    check(f"spike_reduced {label}, factored (the gradient's re-solve)", dtype,
          kernels.spike_reduced(Al, None, Ga, r2, factors=gL)[0],
          kernels.spike_reduced_plain(Al, None, Ga, r2, factors=gL)[0], "spike_reduced", {},
          cuda_ms(lambda: kernels.spike_reduced(Al, None, Ga, r2, factors=gL), reps, 1),
          cuda_ms(lambda: kernels.spike_reduced_plain(Al, None, Ga, r2, factors=gL), reps, 1))


def check_spike_edges(dtype, dev):
    """Phase 3f: K11's and K12's block entries and K18 on random SPD systems at the edges of their 64-row
    tiles and of their column tiles (K11: blocks of 5, 64 and 65, K = 1 and 2, one chain; K12 and K18: blocks
    of 64 and 65; k = 1, 3, 64, 65; P = 1 and 2, with and without the factors), against their plain versions,
    held to SN_TOL; and K11 on three chains of which one has an indefinite block: a NaN logdet for that chain,
    the other two as the plain version gives them."""
    from tpu_gmrf_torch import kernels

    rng = np.random.default_rng(23)

    def spd_blocks(B, K, s):
        G = rng.normal(size=(B, K, s, s))
        D = torch.tensor(G @ np.swapaxes(G, -1, -2) + 2 * s * np.eye(s), dtype=dtype, device=dev)
        return D, torch.tensor(0.3 * rng.normal(size=(B, K - 1, s, s)), dtype=dtype, device=dev)

    worst = {"bt_factor_blocks": 0.0, "bt_trsv_blocks": 0.0, "spike_reduced": 0.0}
    for s in (5, 64, 65):
        for K in (1, 2):
            D, E = spd_blocks(1, K, s)
            worst["bt_factor_blocks"] = max(worst["bt_factor_blocks"], rel_err(
                kernels.bt_factor_blocks(D, E), kernels.bt_factor_blocks_plain(D, E))[1])
    D, E = spd_blocks(3, 3, 70)
    D[1, 1] -= 1000 * torch.eye(70, dtype=dtype, device=dev)  # chain 1's second block is indefinite
    (P, ld), (Pp, ldp) = kernels.bt_factor_blocks(D, E), kernels.bt_factor_blocks_plain(D, E)
    keep = torch.tensor([0, 2], device=dev)
    indefinite = rel_err((P[keep], ld[keep]), (Pp[keep], ldp[keep]))[1]
    if not (bool(torch.isnan(ld[1])) and bool(torch.isfinite(ld[keep]).all()) and bool(torch.isfinite(P[keep]).all())):
        raise AssertionError(f"bt_factor_blocks with an indefinite block in chain 1: logdets {ld.tolist()}")
    worst["bt_factor_blocks"] = max(worst["bt_factor_blocks"], indefinite)
    for s in (64, 65):
        B, K = 2, 3
        G = rng.normal(size=(B, K, s, s))
        D = torch.tensor(G @ np.swapaxes(G, -1, -2) + 2 * s * np.eye(s), dtype=dtype, device=dev)
        E = torch.tensor(0.3 * rng.normal(size=(B, K - 1, s, s)), dtype=dtype, device=dev)
        P = kernels.bt_factor_blocks(D, E)[0]
        for k in (1, 3, 64, 65):
            b = torch.tensor(rng.normal(size=(B, K, s, k)), dtype=dtype, device=dev)
            worst["bt_trsv_blocks"] = max(worst["bt_trsv_blocks"], rel_err(
                (kernels.bt_trsv_blocks(P, b),), (kernels.bt_trsv_blocks_plain(P, b),))[1])
        for Pn in (1, 2):
            for k in (1, 3):
                gamma = 0.3 * rng.normal(size=(Pn, s, s))
                G = rng.normal(size=(Pn, s, s))
                beta = G @ np.swapaxes(G, -1, -2) + 2 * s * np.eye(s)
                alpha = np.concatenate([np.zeros((1, s, s)), np.swapaxes(gamma[:-1], -1, -2)])
                gamma[-1] = 0.0
                a, be, g, r = (torch.tensor(x, dtype=dtype, device=dev)
                               for x in (alpha, beta, gamma, rng.normal(size=(Pn, s, k))))
                gs, gl, gL = kernels.spike_reduced(a, be, g, r)
                ps, pl, _ = kernels.spike_reduced_plain(a, be, g, r)
                fs = kernels.spike_reduced(a, None, g, r, factors=gL)[0]
                fp = kernels.spike_reduced_plain(a, None, g, r, factors=gL)[0]
                worst["spike_reduced"] = max(worst["spike_reduced"], rel_err((gs, gl), (ps, pl))[1],
                                             rel_err((fs,), (fp,))[1])
    torch.cuda.synchronize()
    tol = SN_TOL[dtype]
    log(f"  tile edges, {dtype_name(dtype)}: bt_factor_blocks (s = 5, 64, 65; K = 1, 2; and an indefinite block: "
        f"logdet NaN for its chain only, {indefinite:.3e} on the others) worst rel {worst['bt_factor_blocks']:.3e} "
        f"(tol {tol['bt_factor_blocks']:.0e}); bt_trsv_blocks (s = 64, 65; k = 1, 3, 64, 65) worst rel "
        f"{worst['bt_trsv_blocks']:.3e} (tol {tol['bt_trsv_blocks']:.0e}); spike_reduced (ns = 64, 65; P = 1, 2; "
        f"k = 1, 3; also with factors) worst rel {worst['spike_reduced']:.3e} (tol {tol['spike_reduced']:.0e})")
    if not all(worst[k] <= tol[k] for k in worst):
        raise AssertionError("a SPIKE kernel disagrees with its plain version at a tile edge")


def spike_split(diag, sub, b, P: int) -> dict:
    """Device ms of one SPIKE solve + logdet and of its gradient's re-solve, split by kernel: CUDA events around
    every call of the three kernels' wrappers (recorded by wrapping their names in parallel/pbtridiag.py); the
    rest is the torch code between them. The second of two runs is kept: the first may meet the caching
    allocator's first allocations of the graph's tensors, whose host time the events would count."""
    from unittest import mock

    from tpu_gmrf_torch.parallel import pbtridiag as pb

    names = ("bt_factor_blocks", "bt_trsv_blocks", "spike_reduced")
    spans: list = []

    def timing(name):
        fn = getattr(pb, name)

        def wrapper(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            spans.append((name, e0, e1))
            return out

        return mock.patch.object(pb, name, wrapper)

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with timing(names[0]), timing(names[1]), timing(names[2]):
        for _ in range(2):
            leaves = [t.detach().clone().requires_grad_() for t in (diag, sub, b)]
            spans.clear()
            torch.cuda.synchronize()
            marks[0].record()
            x, _ = pb._pbtridiag_chunks(*leaves, P)
            marks[1].record()
            n_solve = len(spans)
            (x * leaves[2]).sum().backward()
            marks[2].record()
            torch.cuda.synchronize()
    out = {}
    for part, sel, (m0, m1) in (("solve + logdet", spans[:n_solve], marks[:2]), ("gradient", spans[n_solve:], marks[1:])):
        total = m0.elapsed_time(m1)
        per = {name: sum(e0.elapsed_time(e1) for nm, e0, e1 in sel if nm == name) for name in names}
        out[part] = dict(total=total, **per, rest=total - sum(per.values()))
    return out


def spike_path(dn_model, sp_model, dev, card):
    """Phase 17: the SPIKE solve at full width (f64, P = 4 chunks on one card), its gradient, the oracles;
    example 12 part 3; the public entry and the supernodal mesh variant on a one-rank NCCL mesh."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.linear_maps import SymmetricBlockTridiagonalMap, block_tridiag_to_sparse
    from tpu_gmrf_torch.parallel.pbtridiag import _pbtridiag_chunks
    from tpu_gmrf_torch.solvers.supernodal import supernodal_factorize

    diag, sub, b = spike_system(dn_model, torch.float64, dev)
    Nt, ns = b.shape
    leaves = [t.clone().requires_grad_() for t in (diag, sub, b)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    # ---- the SPIKE main path: solve, logdet and the gradient of bᵀQ⁻¹b ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, logdet = _pbtridiag_chunks(*leaves, SPIKE_P)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    (x * leaves[2]).sum().backward()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0 - solve_s
    counts = kernels.launches()
    # ---- end of the SPIKE main path ----
    launched(counts, SPIKE_KERNELS, "SPIKE")
    with torch.no_grad():
        spike_ms = cuda_ms(lambda: _pbtridiag_chunks(diag, sub, b, SPIKE_P), 3, 1)
    log(f"  Nt={Nt} ns={ns} P={SPIKE_P} f64 ({3 * Nt * ns * ns * 8 / 1e9:.2f} GB of blocks): solve + logdet "
        f"{solve_s * 1e3:.1f} ms first call, {spike_ms:.1f} ms per call (events); gradient of bᵀQ⁻¹b "
        f"{grad_s * 1e3:.1f} ms; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    for part, row in spike_split(diag, sub, b, SPIKE_P).items():
        log(f"  {part} by kernel (device ms, events): total {row['total']:.2f} = K11-blocks "
            f"{row['bt_factor_blocks']:.2f} + K12-blocks {row['bt_trsv_blocks']:.2f} + K18 {row['spike_reduced']:.2f} "
            f"+ torch code between them {row['rest']:.2f}")

    t0 = time.perf_counter()
    Qmap = SymmetricBlockTridiagonalMap(diag, sub)
    Qsp = block_tridiag_to_sparse(Qmap)
    asm_s = time.perf_counter() - t0
    f = tg.factorize(Qsp, tg.SolverSpec(kind="supernodal"))
    xs, lds = f.solve(b.reshape(-1)).reshape(Nt, ns), f.logdet()
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0 - asm_s
    xd = x.detach()
    x_err = float((xd - xs).norm() / xs.norm())
    res = float((Qmap.matvec(xd.reshape(-1)) - b.reshape(-1)).norm() / b.norm())
    ld_err = abs(float(logdet) - float(lds)) / abs(float(lds))
    log(f"  against the supernodal solve of the assembled Q (n={Nt * ns}, nnz={Qsp.nnz}; assembly {asm_s:.1f} s, "
        f"plan + factor + solve {oracle_s:.1f} s): x rel {x_err:.3e} (tol {SPIKE_TOL['x']:.0e}), residual "
        f"{res:.3e} (tol {SPIKE_TOL['residual']:.0e}), logdet {float(logdet):.6f} vs {float(lds):.6f} rel "
        f"{ld_err:.3e} (tol {SPIKE_TOL['logdet']:.0e})")
    if not (x_err <= SPIKE_TOL["x"] and res <= SPIKE_TOL["residual"] and ld_err <= SPIKE_TOL["logdet"]):
        raise AssertionError("the SPIKE solve disagrees with the supernodal solve of the assembled Q")
    del Qsp, f

    t0 = time.perf_counter()
    cpu = [t.detach().cpu().requires_grad_() for t in (diag, sub, b)]
    xp, ldp = _pbtridiag_chunks(*cpu, SPIKE_P)
    (xp * cpu[2]).sum().backward()
    plain_s = time.perf_counter() - t0
    errs = {name: float((g.grad.cpu() - p.grad).norm() / p.grad.norm())
            for name, g, p in zip(("diag", "sub", "b"), leaves, cpu)}
    xp = xp.detach()
    errs["x"] = float((xd.cpu() - xp).norm() / xp.norm())
    errs["logdet"] = abs(float(logdet) - float(ldp)) / abs(float(ldp))
    log(f"  against the plain path on CPU tensors ({plain_s:.1f} s on the host): "
        + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items()) + f" (tol {SPIKE_TOL['grad']:.0e})")
    if not all(v <= SPIKE_TOL["grad"] for v in errs.values()):
        raise AssertionError("the SPIKE path on the kernels disagrees with its plain path")
    del cpu, xp, leaves

    d12, s12, b12 = ex12_system(dev)
    with torch.no_grad():
        x12, ld12 = _pbtridiag_chunks(*(torch.tensor(a, device=dev) for a in (d12, s12, b12)), EX12_P)
    Q12 = dense_block_tridiag(d12.astype(np.float64), s12.astype(np.float64))
    err12 = float(np.abs(x12.cpu().numpy().ravel() - np.linalg.solve(Q12, b12.ravel().astype(np.float64))).max())
    dld12 = abs(float(ld12) - np.linalg.slogdet(Q12)[1])
    log(f"  example 12 part 3 (P={EX12_P}, Nt={4 * EX12_P}, ns={EX12_NS}, f32, seed {EX12_SEED}): max err {err12:.2e} "
        f"(limit {EX12_LIMITS['x']:g}), |Δlogdet| {dld12:.2e} (limit {EX12_LIMITS['logdet']:g})")
    if not (err12 < EX12_LIMITS["x"] and dld12 < EX12_LIMITS["logdet"]):
        raise AssertionError("example 12 part 3 fails its own limits")

    with socket.socket() as sock:  # a free port on this host for the one-rank process group
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("time",))
        with torch.no_grad():
            t0 = time.perf_counter()
            xm = tg.pbtridiag_solve(diag, sub, b, mesh)
            ldm = tg.pbtridiag_logdet(diag, sub, mesh)
            torch.cuda.synchronize()
            pub_s = time.perf_counter() - t0
        pub = float((xm - xd).norm() / xd.norm())
        pub_ld = abs(float(ldm) - float(logdet)) / abs(float(logdet))
        Qsn = random_posterior(sp_model, SP_CHAINS, torch.float64, dev, 8)
        f1, fm = supernodal_factorize(Qsn), supernodal_factorize(Qsn, mesh=mesh)
        sn_diff = float((f1.vals - fm.vals).abs().max())
        sn_ld = float((f1.logdet() - fm.logdet()).abs().max())
    finally:
        dist.destroy_process_group()
    log(f"  public pbtridiag_solve + pbtridiag_logdet on a one-rank NCCL DeviceMesh (one chunk of {Nt}): "
        f"{pub_s * 1e3:.1f} ms, x rel {pub:.3e} and logdet rel {pub_ld:.3e} from the 4-chunk solve (tol "
        f"{SPIKE_TOL['public']:.0e}); supernodal_factorize(mesh=) at n={sp_model.n}, B={SP_CHAINS}: values max "
        f"|Δ| {sn_diff:.1e}, logdets {sn_ld:.1e} from the unsharded factor (must be 0)")
    if not (pub <= SPIKE_TOL["public"] and pub_ld <= SPIKE_TOL["public"] and sn_diff == 0.0 and sn_ld == 0.0):
        raise AssertionError("the public SPIKE entry or the supernodal mesh variant disagrees")
    return counts


def fault_path(dev, card):
    """Phase 18: fault 3.1 on the card. d/dτ of a sum-to-zero ConstrainedGMRF's logpdf over
    Q(τ) = τ·tridiag(−1, 2.5, −1), n = 6, on every direct backend, and of linear_condition's mean sum at the KL
    n=900 setup of phase 15 (Q(τ) = τ·Q_KL); against the plain path on CPU tensors and a difference."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.kl_cholesky import gram
    from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern, from_dense

    n = 6
    T = torch.tensor(np.diag(np.full(n, 2.5)) - np.diag(np.ones(n - 1), 1) - np.diag(np.ones(n - 1), -1))
    x = np.linspace(-1.0, 1.0, n)
    x -= x.mean()

    def constrained(kind, tau):
        Q = from_dense(T.to(tau.device))
        g = tg.GMRF.from_precision(torch.zeros(n, dtype=torch.float64, device=tau.device),
                                   SparseMatrix(Q.data * tau, Q.pattern), tg.SolverSpec(kind=kind, block=2))
        return tg.ConstrainedGMRF.create(g, np.ones((1, n)), np.zeros(1)).logpdf(torch.tensor(x, device=tau.device))

    X30 = grid_points(KL_GRID_SMALL)
    n30 = len(X30)
    rng = np.random.default_rng(123)
    rng.integers(0, n30, size=12)  # example 09's probe columns, drawn before its observations
    obs = rng.integers(0, n30, size=5)
    y = np.sin(4 * X30[obs, 0]) * np.cos(3 * X30[obs, 1])

    def conditioned(g, tau):
        where = tau.device
        A = SparseMatrix(torch.ones(len(obs), dtype=torch.float64, device=where),
                         SparsePattern(np.arange(len(obs)), obs, (len(obs), n30)))
        prior = tg.GMRF.from_precision(g.mean.to(where), SparseMatrix(g.Q.data.to(where) * tau, g.Q.pattern))
        return tg.linear_condition(prior, y, Q_eps=1e4, A=A)

    def grad(fn, tau, where):
        t = torch.tensor(tau, dtype=torch.float64, device=where, requires_grad=True)
        v = fn(t)
        v.backward()
        return float(v.detach()), float(t.grad)

    g30 = tg.approximate_gmrf_kl(torch.tensor(X30, device=dev), gram(matern32), rho=KL_RHO, jitter=KL_JITTER)
    g30 = dataclasses.replace(g30, mean=g30.mean.detach(), Q=SparseMatrix(g30.Q.data.detach(), g30.Q.pattern))
    kernels.reset_launches()
    # ---- the fault-3.1 path: gradients through the direct solves on the card ----
    probe = {kind: grad(lambda t, k=kind: constrained(k, t), 1.3, dev) for kind in ("tridiag", "dense", "banded", "supernodal")}
    kl = grad(lambda t: conditioned(g30, t).mean.sum(), 1.0, dev)
    counts = kernels.launches()
    # ---- end of the fault-3.1 path ----
    launched(counts, FAULT_KERNELS, "fault 3.1")
    tol = FAULT_TOL["grad"]
    h = 1e-6
    for kind, (v, gk) in probe.items():
        _, gp = grad(lambda t, k=kind: constrained(k, t), 1.3, "cpu")
        with torch.no_grad():
            one = torch.ones((), dtype=torch.float64, device=dev)
            cd = (float(constrained(kind, (1.3 + h) * one)) - float(constrained(kind, (1.3 - h) * one))) / (2 * h)
        e_p, e_cd = abs(gk - gp) / abs(gp), abs(gk - cd) / abs(cd)
        log(f"  {kind}: constrained logpdf {v:.12f}, d/dτ {gk:.12f} (the JAX package: -0.17692); plain {gp:.12f} "
            f"rel {e_p:.1e}, central difference {cd:.12f} rel {e_cd:.1e} (tol {tol:.0e})")
        if not (e_p <= tol and e_cd <= tol):
            raise AssertionError(f"fault 3.1: the {kind} solve's gradient disagrees")
    v, gk = kl
    _, gp = grad(lambda t: conditioned(g30, t).mean.sum(), 1.0, "cpu")
    with torch.no_grad():
        one = torch.ones((), dtype=torch.float64, device=dev)
        post = conditioned(g30, one)
        ones = torch.ones(n30, dtype=torch.float64, device=dev)
        fwd = float(post.factor.solve(ones) @ g30.Q.matvec(g30.mean - post.mean))  # 1ᵀ Q_post⁻¹ Q (μ₀ − μ)
        h = 1e-5
        hi, lo = conditioned(g30, (1 + h) * one), conditioned(g30, (1 - h) * one)
        cdiff = float(hi.factor.solve(ones) @ g30.Q.matvec(g30.mean - lo.mean))  # (f(1+h) − f(1−h)) / 2h
    e_p, e_f, e_cd = abs(gk - gp) / abs(gp), abs(gk - fwd) / abs(fwd), abs(gk - cdiff) / abs(cdiff)
    log(f"  KL n={n30} (auto -> {tg.SolverSpec().resolve(g30.Q.pattern).kind}): linear_condition mean sum {v:.10f}, "
        f"d/dτ {gk:.12e}; plain {gp:.12e} rel {e_p:.1e} (tol {tol:.0e}), forward derivative {fwd:.12e} rel {e_f:.1e} "
        f"(tol {FAULT_TOL['kl_fwd']:.0e}), central difference (h=1e-5) {cdiff:.12e} rel {e_cd:.1e} "
        f"(tol {FAULT_TOL['kl_cd']:.0e}); on {card}")
    if not (e_p <= tol and e_f <= FAULT_TOL["kl_fwd"] and e_cd <= FAULT_TOL["kl_cd"]):
        raise AssertionError("fault 3.1: linear_condition's mean gradient disagrees at the KL setup")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_gmrf_torch import kernels, native
    from tpu_gmrf_torch.kernels import build
    from tpu_gmrf_torch.samplers import value_and_grad

    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices={torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"phase 2 build: {os.path.basename(lib_path)} built and loaded in {time.perf_counter() - t0:.2f} s; "
        f"host symbolic core: {'native C++ (g++)' if native.native_available() else 'NumPy fallback'}")

    log(f"phase 3 kernels K1-K4 vs plain on {card}")
    check_kernels(torch.float64, dev)
    results = check_kernels(torch.float32, dev)

    log(f"phase 3 (extended) K4 and K1-K3 beyond shared memory, on {card}")
    stats_model = spatial_model(STATS_GRID)
    check_beyond_shared_memory(stats_model, dev)

    log(f"phase 3b kernels K5-K8 vs plain, g={SP_GRID}, B={SP_CHAINS}, on {card}")
    sp_model = spatial_model(SP_GRID)
    check_spatial_kernels(sp_model, torch.float64, dev)
    results.update(check_spatial_kernels(sp_model, torch.float32, dev))

    log(f"phase 3c kernels K9-K12 vs plain and library: dense at g={DN_GRID} B={DN_CHAINS}, banded at g={SP_GRID} "
        f"B={SP_CHAINS}, on {card}")
    dn_model = spatial_model(DN_GRID)
    check_dense_kernels(dn_model, sp_model, torch.float32, dev)
    results.update(check_dense_kernels(dn_model, sp_model, torch.float64, dev))  # the NUTS paths run float64

    log(f"phase 3d multiply kernels K13-K15, bt_sqrt, K7 multiply vs plain and library, on {card}")
    grid_q = {dt: grid_precision(dt, dev) for dt in (torch.float64, torch.float32)}
    check_multiply_kernels(stats_model, sp_model, grid_q, torch.float64, dev)
    results.update(check_multiply_kernels(stats_model, sp_model, grid_q, torch.float32, dev))

    log(f"phase 3e kernels K16 kl_columns, K17 block_inv and rectangular K4 vs plain and library, on {card}")
    kp = kl_problem(KL_GRID)
    _, Qt1k, Xall = glasso_problem(GL["n"], GL["m"], GL["density"], GL["held_out"])
    gp = glasso_host(Xall[:GL["m"]], GL["lam"])
    gp.update(X=Xall[:GL["m"]], Qt=Qt1k)
    log(f"  glasso n={GL['n']} host: " + ", ".join(f"{k} {v:.2f} s" for k, v in gp["host"].items()))
    results.update(check_gp_kernels(kp, gp, dev))

    log(f"phase 3f K11/K12 block entries and K18 spike_reduced vs plain and library: the SPIKE solve at "
        f"Nt={SPIKE_NT}, ns={dn_model.n}, P={SPIKE_P} and example 12's shape, on {card}")
    sys17 = spike_system(dn_model, torch.float64, dev)
    check_spike_kernels(f"Nt={SPIKE_NT} P={SPIKE_P}", *(t.float() for t in sys17), SPIKE_P, torch.float32, {}, 3)
    check_spike_kernels(f"Nt={SPIKE_NT} P={SPIKE_P}", *sys17, SPIKE_P, torch.float64, results, 3, sweep=True)
    del sys17
    ex12 = [torch.tensor(a, device=dev) for a in ex12_system(dev)]
    for dt in (torch.float32, torch.float64):
        check_spike_kernels(f"example 12 P={EX12_P}", *(t.to(dt) for t in ex12), EX12_P, dt, {})
        check_spike_edges(dt, dev)

    log(f"phase 4 flagship slice: laplace_marginal value+grad, B={CHAINS}, n={N}, max_iter={GA_MAX_ITER}")
    y = flagship_y()
    z = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(CHAINS, 2)), dtype=torch.float32)
    ld = logdensity(y)

    kernels.reset_launches()
    # ---- flagship main path: value+grad (float32, kernels) and HMC ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v32, g32 = value_and_grad(ld, z.to(dev))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        value_and_grad(ld, z.to(dev))
    torch.cuda.synchronize()
    vg_ms = (time.perf_counter() - t0) / reps * 1e3
    state, accepts, hmc_ms = run_hmc(ld, z.to(dev), HMC_STEPS, STEP_SIZE, dev)
    counts = kernels.launches()
    # ---- end of the flagship main path ----
    launched(counts, FLAGSHIP_KERNELS, "flagship")

    v64p, g64p = value_and_grad(ld, z.double())  # plain path: the same code on CPU tensors
    v64k, g64k = value_and_grad(ld, z.double().to(dev))  # kernel path, float64
    check_slice("f64", v64k, g64k, v64p, g64p, CHAINS, "f64")
    check_slice("f32", v32, g32, v64p, g64p, CHAINS, "f32")
    log(f"  flagship f32 value+grad: first call {first_s:.3f} s, then {vg_ms:.2f} ms per batched "
        f"value+grad of {CHAINS} chains on {card} (PERF.md records 28-40 ms on an H100 at 700 W; "
        f"tools/time_flagship_vg.py times this value+grad on two trees in turns)")
    if not bool(torch.isfinite(state.position).all()):
        raise AssertionError("HMC positions are not finite")
    log(f"phase 5 HMC: {HMC_STEPS} steps x {LEAPFROG} leapfrog, step size {STEP_SIZE}: "
        f"{hmc_ms:.1f} ms per step, mean acceptance {np.mean(accepts):.3f} "
        f"(per step {', '.join(f'{a:.3f}' for a in accepts)}) on {card}")

    log(f"phase 6 GMRF statistics, g={STATS_GRID}, B=1, kernels vs plain on {card}")
    gmrf_statistics(stats_model, dev)

    log(f"phase 7 spatial slice: Matérn + Poisson laplace_marginal value+grad, n={sp_model.n}, "
        f"B={SP_CHAINS}, max_iter={SP_GA_ITER}, supernodal")
    sp_y = spatial_y(sp_model, SP_GRID)
    sp_ld = spatial_logdensity(sp_model, sp_y)
    sp_z = torch.tensor(np.tile([0.0, np.log(0.3)], (SP_CHAINS, 1))
                        + np.random.default_rng(5).normal(scale=0.3, size=(SP_CHAINS, 2)), dtype=torch.float32)

    kernels.reset_launches()
    # ---- spatial main path: value+grad (float32, kernels) and HMC ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv32, sg32 = value_and_grad(sp_ld, sp_z.to(dev))
    torch.cuda.synchronize()
    sp_first_s = time.perf_counter() - t0
    one_call = kernels.launches()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        value_and_grad(sp_ld, sp_z.to(dev))
    torch.cuda.synchronize()
    sp_vg_ms = (time.perf_counter() - t0) / reps * 1e3
    sp_state, sp_accepts, sp_hmc_ms = run_hmc(sp_ld, sp_z.double().to(dev), SP_HMC_STEPS, SP_STEP_SIZE, dev)
    sp_counts = kernels.launches()
    # ---- end of the spatial main path ----
    launched(sp_counts, SPATIAL_KERNELS, "spatial")
    log(f"  launches per f32 value+grad (first call): {one_call}; Newton iterations "
        f"{newton_iterations(sp_model, sp_y, sp_z.to(dev))}")

    t0 = time.perf_counter()
    sv64p, sg64p = value_and_grad(sp_ld, sp_z.double())  # plain path on CPU tensors
    plain_s = time.perf_counter() - t0
    sv32p, sg32p = value_and_grad(sp_ld, sp_z)  # the f32 plain path on CPU tensors, same inputs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv64k, sg64k = value_and_grad(sp_ld, sp_z.double().to(dev))
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t0) * 1e3
    check_slice("f64", sv64k, sg64k, sv64p, sg64p, SP_CHAINS, "f64", SP_SLICE_TOL)
    check_slice("f32", sv32, sg32, sv64p, sg64p, SP_CHAINS, "f32", SP_SLICE_TOL)
    check_slice("f32", sv32, sg32, sv32p, sg32p, SP_CHAINS, "f32p", SP_SLICE_TOL, "f32 plain")
    v_rel, g_rel, per_chain = slice_errors(sv32p, sg32p, sv64p, sg64p)
    log(f"  (for comparison) slice f32 plain vs f64 plain, both on CPU tensors: value max rel {v_rel:.3e}, "
        f"grad max rel {g_rel:.3e}{per_chain}")
    log(f"  spatial f32 value+grad: first call {sp_first_s:.3f} s, then {sp_vg_ms:.1f} ms per batched "
        f"value+grad of {SP_CHAINS} chains on {card}; f64 on the kernels {f64_ms:.1f} ms (one call); "
        f"f64 plain on the host CPU {plain_s:.1f} s")
    if profile:
        profile_value_and_grad(sp_ld, sp_z.to(dev))
    if not bool(torch.isfinite(sp_state.position).all()):
        raise AssertionError("spatial HMC positions are not finite")
    log(f"phase 8 spatial HMC (f64): {SP_HMC_STEPS} steps x {LEAPFROG} leapfrog, step size {SP_STEP_SIZE}: "
        f"{sp_hmc_ms:.1f} ms per step, mean acceptance {np.mean(sp_accepts):.3f} "
        f"(per step {', '.join(f'{a:.3f}' for a in sp_accepts)}) on {card}")

    w, ns_, dp_ = NUTS_FLAGSHIP["warmup"], NUTS_FLAGSHIP["samples"], NUTS_FLAGSHIP["depth"]
    log(f"phase 9 flagship run_nuts: B={CHAINS}, n={N}, f32, max_depth {dp_}, {w} warmup + {ns_} samples "
        f"(cut from the bench's 100 + 100)")
    # ---- flagship NUTS main path ----
    res, secs, counts9 = timed_nuts(ld, torch.zeros(CHAINS, 2, dtype=torch.float32, device=dev), w, ns_, dp_, 1)
    # ---- end of the flagship NUTS main path ----
    launched(counts9, FLAGSHIP_KERNELS, "flagship NUTS")
    log(f"  flagship NUTS: {nuts_line(res, secs)} on {card}")

    cfg = NUTS_G16
    log(f"phase 10 spatial run_nuts at g={cfg['grid']}: n={dn_model.n}, {cfg['chains']} chains, max_depth "
        f"{cfg['depth']}, {cfg['warmup']} warmup + {cfg['samples']} samples (uncut), ga_iters {cfg['ga_iter']}, "
        f"supernodal prior, inner solver auto -> {tg_resolve(dn_model)}, f64")
    ld16 = spatial_logdensity(dn_model, spatial_y(dn_model, cfg["grid"]), cfg["ga_iter"], inner=None)
    init16 = torch.tensor(np.tile([0.0, np.log(0.3)], (cfg["chains"], 1)), dtype=torch.float64, device=dev)
    # ---- g=16 NUTS main path ----
    res, secs, counts10 = timed_nuts(ld16, init16, cfg["warmup"], cfg["samples"], cfg["depth"])
    # ---- end of the g=16 NUTS main path ----
    launched(counts10, NUTS_G16_KERNELS, "g=16 NUTS")
    log(f"  g=16 NUTS: {nuts_line(res, secs)} on {card}")

    cfg = NUTS_5741
    log(f"phase 11 spatial run_nuts at n={sp_model.n}: {cfg['chains']} chains, max_depth {cfg['depth']}, "
        f"{cfg['warmup']} warmup + {cfg['samples']} samples (uncut), ga_iters {cfg['ga_iter']}, supernodal prior, "
        f"inner solver auto -> {tg_resolve(sp_model)}, f64")
    ld11 = spatial_logdensity(sp_model, sp_y, cfg["ga_iter"], inner=None)
    init11 = torch.tensor(np.tile([0.0, np.log(0.3)], (cfg["chains"], 1)), dtype=torch.float64, device=dev)
    # ---- n=5741 NUTS main path ----
    res, secs, counts11 = timed_nuts(ld11, init11, cfg["warmup"], cfg["samples"], cfg["depth"])
    # ---- end of the n=5741 NUTS main path ----
    launched(counts11, NUTS_5741_KERNELS, "n=5741 NUTS")
    log(f"  n={sp_model.n} NUTS: {nuts_line(res, secs)} on {card}; depth per transition "
        f"{res.depth.tolist()}; launches of K4-K12 "
        f"{ {k: v for k, v in counts11.items() if not k.startswith('tridiag')} }")
    z = res.samples[:, -1].contiguous()
    (vb, gb), banded_ms, one_vg = timed_value_and_grad(ld11, z)
    (vs, gs), sn_ms, _ = timed_value_and_grad(
        spatial_logdensity(sp_model, sp_y, cfg["ga_iter"], inner="supernodal"), z)
    log(f"  one value+grad at the last draws: {banded_ms:.1f} ms on the banded inner solver, {sn_ms:.1f} ms on "
        f"the supernodal one, on {card}; launches per value+grad on the banded path "
        f"{ {k: v for k, v in one_vg.items() if v} }")
    v_rel, g_rel, per_chain = slice_errors(vb, gb, vs, gs)
    log(f"  value+grad, banded inner vs supernodal inner, same θ: value max rel {v_rel:.3e} (tol "
        f"{NUTS_TOL['value']:.0e}), grad max rel {g_rel:.3e} (tol {NUTS_TOL['grad']:.0e}){per_chain}")
    if not (v_rel <= NUTS_TOL["value"] and g_rel <= NUTS_TOL["grad"]):
        raise AssertionError("the banded and supernodal inner solvers disagree")
    fixed = nuts_fixed_draws(ld11, z, res.step_size, res.inv_mass, cfg["depth"], dev)
    (sk, ik), (sp_, ip) = fixed["cuda"], fixed["cpu"]
    pos_err = float((sk.position.cpu() - sp_.position).abs().max())
    log(f"  nuts_transition, fixed draws, kernels vs plain (CPU tensors): depth {ik.depth.tolist()} / "
        f"{ip.depth.tolist()}, leaves {ik.num_leaves.tolist()} / {ip.num_leaves.tolist()}, positions max abs "
        f"diff {pos_err:.3e} (tol {NUTS_TOL['position']:.0e}); {fixed['cuda_s']:.2f} s on the card, "
        f"{fixed['cpu_s']:.2f} s on the host CPU")
    if ik.depth.tolist() != ip.depth.tolist() or ik.num_leaves.tolist() != ip.num_leaves.tolist() \
            or not pos_err <= NUTS_TOL["position"]:
        raise AssertionError("nuts_transition on the kernels disagrees with the plain path")

    log(f"phase 12 the multiply path: bench_spmv, n={stats_model.n}, k={SPMV_VECS}, f32, {SPMV_CHAIN} chained "
        f"normalized multiplies per timing, on {card}")
    counts12 = multiply_path(stats_model, dev, card)
    log(f"phase 13 the CG path: {CG_GRID}x{CG_GRID} grid precision, n={CG_GRID * CG_GRID}, {CG_RHS} right-hand sides, "
        f"on {card}")
    counts13 = cg_path(grid_q, dev, card)
    log(f"phase 13b CG on the Matérn operator, n={stats_model.n}, f64, on {card}")
    counts13b = cg_matern_path(stats_model, dev, card)
    log(f"phase 14 RBMC variances and N(0, Q) draws, on {card}")
    counts14 = rbmc_path(stats_model, sp_model, dev, card)
    log(f"phase 15 the KL path: example 09 at g={KL_GRID_SMALL} and g={KL_GRID} (rho={KL_RHO:g}), f64, on {card}")
    counts15 = kl_path(kp, dev, card)
    log(f"phase 16 the graphical lasso: example 10 at n={GL_SMALL['n']} and n={GL['n']}, f64, on {card}")
    counts16 = glasso_path(gp, Xall[GL["m"]:], dev, card)
    log(f"phase 17 the SPIKE path: Q_t ⊗ Q_s, Nt={SPIKE_NT}, ns={dn_model.n}, P={SPIKE_P} chunks, f64; example 12 "
        f"part 3; the public entry and supernodal_factorize(mesh=) on a one-rank NCCL mesh, on {card}")
    counts17 = spike_path(dn_model, sp_model, dev, card)
    log(f"phase 18 fault 3.1: gradients through the direct solves, f64, on {card}")
    counts18 = fault_path(dev, card)

    paths = (counts, sp_counts, counts9, counts10, counts11, counts12, counts13, counts13b, counts14, counts15,
             counts16, counts17, counts18)
    report = {
        "kernels": [
            {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
             "launches": sum(c[name] for c in paths), **results[name]}
            for name in kernels.KERNELS
        ]
    }
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
