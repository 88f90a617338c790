#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_gmrf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. the device: needs CUDA; prints the card's name and power limit;
2. the build: compiles the kernels K1-K25 (K5 with its second entry,
   fct_init; K7 with its multiply mode and that mode's transpose,
   sn_multiply_t; K10 with its second entry, dense_selinv; K11 and K12 with
   their block entries, bt_factor_blocks and bt_trsv_blocks; K13 with its
   second entry, bt_sqrt, and that entry's transpose mode, bt_sqrt_t) from
   tpu_gmrf_torch/csrc with nvcc (one nvcc per source, in parallel) and
   the host symbolic core with g++;
3. K1-K4 against their plain PyTorch versions on the card, at the flagship
   shapes (B=256 chains, n=500), in float64 and float32; K1-K3 at the
   edges of their segmented scans (n = 1, 2, 31, 32, 33, 129, 500, 1025,
   2049, 8193, 20000; B = 1, 3, 256; K2 in modes 0-2 at k = 1, 3, 64), on a batch with
   one clearly negative pivot (a NaN logdet on that chain only, d NaN where
   the plain version's is; K3's z NaN where the plain version's is, finite
   above the pivot) and on the near-singular RW1 + ridge chain; then
   beyond shared memory: K4 at n=14058 (B=1 and 8, values shared and per
   chain, with the quadratic form) also against CSR ``torch.sparse.mm``,
   and K1-K3 at n=20000, B=4;
3b. K5-K8 against their plain versions on the card at the spatial shapes
   (Matérn α=2 on the 63×63 grid, n=5741, B=4 chains: the prior at τ=1,
   range=0.25 and the posterior with a random positive diagonal H), in
   float64 and float32, over the whole supernodal schedule; K5 on every
   level's Schur and forward plan, on a plan of mixed rows in two parts, on
   the one-launch logdet and selinv_dot sums, with its launches per
   factorization and solve, and on sp_add's plan at the flagship shape
   beside CSR torch.sparse.mm of the plan's 0/1 matrix; K8's two
   entries each on its own (sn_takahashi_prep's C and A; sn_takahashi's
   sweep on the kernel's C and A), then the whole Σ, with the library
   yardstick torch.cholesky_inverse of the densified factor;
3c. K9-K10 and dense_selinv (the dense backend, g=16 posterior, n=450,
   B=8; K9 also through its rescue on the card, three chains that need δ,
   500δ and break down, equal levels required; at B=1, n=900 and n=1000,
   the shapes of phases 15 and 16, and n=4096; and one call in a
   torch.profiler trace: one launch, no device-to-host copy, no stream
   synchronize; K10 on K9's tiles in modes 0, 1 and 2 at k = 1, 8 and 65
   at each of those shapes, and raising without the tiles) and K11-K12
   (the banded backend, n=5741, B=4, s=512, K=12; K11 also
   at s=496 through the plan's block=8, and through its rescue: one chain
   with an indefinite block, equal boosts required; K12 at k = 1, 8, 9 and 65
   right-hand sides, and in modes 0, 1 and 2 on the s=512, the s=496 and
   the forced-rescue factors; K8's two entries and the whole banded
   Takahashi sweep) against their plain versions and against the
   library call, where one computes the same function or its blocks (K11:
   cholesky_ex of the K blocks and solve_triangular for the M_k; K12:
   solve_triangular both ways on each block; the whole banded Σ:
   cholesky_inverse of the densified factor, then the gather onto the
   blocks), in float64 and float32;
3d. the multiply kernels against their plain versions, in float64 and
   float32: K13 bt_matvec and K14 bsr_spmm at the bench_spmv operator
   (Matérn α=2 on 100x100 points, n=14058, 8 vectors) and at the 316x316
   grid precision (n=99856), K14 at each block size forward and
   transposed, K15 bsr_outer, the BSR gradient against the plain version's
   autograd, K4 at those sizes, bt_sqrt on the n=5741 banded factor and K7's
   multiply mode on the n=14058 supernodal factor; K13 with the bytes it
   moves and its rate, and at its edges (one block; blocks of 91 and 96 rows
   with 9 vectors; per-chain blocks), bt_sqrt at phase 14's shape; K14 at
   its edges, forward and transposed at each block size (blocks per row
   with 3 vectors, one vector, 9 vectors, blocks off 16 bytes, n=5741 not a
   multiple of bs), each launched twice and equal bit for bit; K15 beside
   torch.sparse.sampled_addmm at the stored blocks' scalar pattern, and at its
   edges (per chain with 3 chains, one vector, 9 vectors, n=5741, at each block
   size), each launched twice and equal bit for bit;
3e. K16 kl_columns on the column buckets of example 09's KL factor at
   n=10,000 (rho = 3 and 6) and on one bucket of cap 256 (its cluster
   path); the warp path to the bit, the tile and cluster paths by backward
   error and by distance from the plain version against the library's; K17
   block_inv on the n=1000 graphical lasso's cliques and separators (and one
   set of 200, beyond shared memory; and at its class edges: one set on each
   side of every edge of its size classes, an indefinite set that interchanges
   rows, a singular set whose NaN values must be the plain version's, each
   launched twice and equal bit for bit), rectangular K4 on a 500 x 14058
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
3g. the selected inverse's tangents (Σ̇ = −Σ·Q̇·Σ): K19
   tridiag_selinv_tangent at the flagship's shape beside the library's Σ̇
   (torch.cholesky_inverse and two products) and at its scan's edges (n = 1
   to 20,000), K20 sn_panel_tangent and K21
   sn_takahashi_tangent launch by launch over phase 3b's supernodal
   schedule, K22 bt_factor_tangent and K21 on the banded blocks at n=5741,
   B=4, against their plain versions (float64 on the kernels' inputs), in
   float32 and float64, and the whole Σ̇ at Q's pattern against a dense
   inverse's;
3h. the factorizations' adjoints (the cotangent of Q from that of its
   factor, for gradients through sampling, triangular solves and
   sqrt_matvec): K23 tridiag_factor_adjoint at the flagship's shape, K24
   bt_factor_adjoint on the banded blocks (n=5741, B=4, K=12, s=512), K25
   sn_panel_adjoint launch by launch over phase 3b's supernodal schedule, and
   the transpose products, one launch each, on those factors at k=16, 1 and 40
   (bt_sqrt_t; sn_multiply_t over the whole schedule, also at n=14058, B=1;
   each twice, equal bit for bit, an Lᵀz through the supernodal factor
   counted as one K7 launch), against their plain versions (float64 on the
   kernels' inputs) and the
   library's (autograd through torch.linalg.cholesky of the densified,
   permuted, equilibrated matrix; the densified factor's transpose times the
   rows), in float32 and float64;
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
   kernel, against the supernodal solve and logdet of the assembled sparse Q at Nt=32 (residual by
   SymmetricBlockTridiagonalMap; the SPIKE solve at that Nt in the same chunks) and the
   plain path on CPU tensors; example 12 part 3 with its own limits; the
   public pbtridiag_solve / pbtridiag_logdet on a one-rank NCCL DeviceMesh
   and supernodal_factorize(mesh=) on it at n=5741;
18. fault 3.1: d/dτ through the direct solves on the card (a sum-to-zero
   ConstrainedGMRF's logpdf on every direct backend; linear_condition's mean
   at the KL n=900 setup), against the plain path and a difference, f64;
19. constrained Laplace (bench_micro's GA row, bench.py:395-406): the
   Laplace marginal and its τ-gradient of RW1(500) + Poisson over 256
   chains in float32 (K1-K3 through the KKT-projected Newton mode and its
   IFT backward), against the float64 plain and kernel paths, with the
   float32 plain path's own distance beside it; RW2(500) (two constraints,
   auto -> dense, K9/K10) over 8 chains in float64; every mode on A x = e;
20. the areal models at example 08's size (the 100x100 grid, N=10,000):
   BesagModel's construction (its normalization on the card), Besag +
   Poisson value+grad over 4 chains and BYM2 (n=20,000) logpdf with its
   (τ, φ) gradient, f64, auto -> banded (K11/K12, K8), against the plain
   path on CPU tensors; example 08's τ-profile (50 τ through
   make_workspace_pool(...).batch_evaluate, batch_size 10) in float32 and
   float64 against its golden anchor;
21. examples 01, 02 and 05 with their seeded inputs, in float32 and float64,
   against their golden literals (tools/golden_values.py); example 05's
   forecast RMSE, which depends on the JAX package's draw, is printed and
   not held;
22. observation breadth: (a) example 03's Bernoulli marks through the FEM
   evaluation matrix (LinearlyTransformedObservationModel) at the spatial
   slice's size (n=5741, supernodal, 4 chains), value+grad over (τ, range)
   in float32 and float64, each against its own plain path, with K4's
   rectangular launches per likelihood gradient and the posterior's
   pattern; (b) normal observations under the log link on AR1(500) over
   256 chains, float32 against the f64 plain path (Newton from the data's
   log: from the prior mean no chain converges, in either package); (c)
   example 03 at its own size against its literals, float32 and float64;
23. a non-Gaussian prior: the Student-t random walk of
   tests/test_nongaussian_priors.py as a StructuredLatentPrior at the
   flagship's width (n=500, 256 chains, Poisson observations),
   marginal_loglikelihood and its log_tau-gradient through NewtonModeNL,
   float32 and float64 against the f64 plain path (auto -> tridiag, K1-K5);
   the same log-density as an AutoDiffLatentPrior on the tridiagonal
   pattern (coloured HVPs) equal to it in float64 over 8 chains;
24. second derivatives: the per-chain θ-Hessian of laplace_marginal (one
   gradient with create_graph=True, a backward pass per component) of the
   flagship in (log τ, atanh ρ) at phase 4's θ, f64 and f32 (K1-K5, K19),
   of the spatial slice at n=5741 in (log τ, log range), f64, on the
   supernodal backend (K20, K21) and, the model's solver and the inner one
   auto, on the banded one (K22, K21), and of the g=16 slice (auto ->
   dense, K10's entries), each against the f64 plain path on
   CPU tensors, for symmetry and against central differences of its own
   gradient; fault 3.4's check, the Hessian of GMRF.logpdf at AR1(500)
   through K4 against −Q; example 13 on the card with its own checks
   (reverse = forward gradient, differences, a symmetric Hessian, Adam
   recovers (τ, μ), a positive definite Hessian at the optimum); and d/dθ
   of Σ var_i at n=14058 (supernodal) against a central difference;
25. pathwise gradients through the factor: the per-chain θ-gradient of the
   mean over 16 draws of GMRF.sample of the Poisson log-likelihood, (a) on
   the flagship (f64 and f32), (b) on the spatial prior at n=5741
   (supernodal f64 and f32; auto -> banded f64), with the gradient of
   sqrt_matvec in θ and in its input (the transpose modes), (c) at g=16
   (auto -> dense), each against the f64 plain path on CPU tensors and a
   central difference at fixed noise; (d) the flagship's pathwise
   ∂/∂θ E Σ x_i² against ∂/∂θ Σ var_i through the selected inverse, within 5
   Monte Carlo standard errors; (e) at phase 17's SPIKE shape the logdet's
   gradient against a central difference, on a one-rank NCCL mesh against
   the in-process chunks, and the solve's Hessian-vector product against the
   f64 plain path;
26. space-time and FEM breadth (tpu_gmrf/fem/spatiotemporal.py, mesh.py,
   discretization.py, obs_models.py; supernodal.py:1258 solve_refined):
   (a) example 04 as written (advection-diffusion joint, Nx=201, Nt=71,
   n=14,271, linear_condition on 101 observations), f64, its assertions and
   golden literals, the backend SolverSpec() picks, and the posterior mean
   against the same backend's plain versions on the card; (b) the full-width
   2-D path: AdvectionDiffusionSPDE on phase 10's g=16 mesh (ns=450) over
   ST_NT time steps, discretize, the Laplace approximation with Poisson
   counts drawn from one prior draw at every 4th step, the posterior's
   time_means, time_stds and 16 time_rands, each step's host time and the
   launches; the joint Q against CPU tensors, the Newton mode and stds
   against the plain versions on the card, the draws by their moments;
   (c) example 11 as written (dense, f64) against its four literals; (d)
   example 14 on icosphere(3) (supernodal, f64) against its literals, and
   solve_refined against the plain solve; (e) example 15 as written (580
   points, Bernoulli through PointEvaluationObsModel, f32), its assertions;
27. samplers breadth and chains over a mesh, on a one-rank NCCL DeviceMesh
   whose dimension is named "chains": (a) at the flagship's width (AR1(500),
   Poisson, f32) run_smc over 256 particles (example 12's split of the
   log-density; the λ schedule, the log evidence and the seconds per stage),
   run_advi with 256 ELBO draws, run_nuts and run_hmc over the mesh equal to
   the same calls without it (256 chains, 4 + 4 draws), and
   run_nuts_checkpointed interrupted after 4 draws and resumed to 8, equal to
   an uninterrupted run; SMC's first λ and evidence increment and ADVI's
   first gradient at fixed noise on the kernels (f32, f64) against the f64
   plain path on CPU tensors; (b) example 12 parts 1-2 as written on the mesh
   (NUTS at n=64, 2 chains, draws cut to 50 + 50; SMC over 32 particles), its
   assertion; (c) example 07 as written (CAR on N=21, 4 chains, 300 + 500
   draws, max_depth 8, auto -> dense), both truths in their 95% intervals, the
   logpdf at the truth on the port's draw against a NumPy f64 dense oracle;
   (d) the dryrun_multichip twin (tpu_gmrf_torch/multichip.py) on the mesh;
28. the formula interface and shapefile contiguity (tpu_gmrf/formula/, geo.py):
   (a) example 06's jittered districts at 100 x 100 (N=10,000) written as one
   .shp, read back, queen and rook W (symmetric, equal to W from the polygons
   in memory, 8 and 4 neighbours inside), each step's host seconds; (b) the
   disease map at that N: "y ~ 1 + aff + Besag(district, W) + IID(district)"
   and "y ~ 1 + aff + BYM2(district, W)" (20,002 unknowns each, Poisson with
   exposure, example 06's recipe at seed 7), 4 chains, f64: what SolverSpec()
   resolves the posterior to and its host seconds, laplace_marginal's value
   and θ-gradient against the plain path on CPU tensors, the constrained
   modes' residual, at one θ the posterior mean, std and 400 draws for
   P(RR > 1), the example's recovery checks; (c) example 06 as written
   (56 districts, both forms) with its asserts; (d) every term (IID + RW1,
   Besag with exposure, BYM2, Separable, predict_cols with and without fixed
   terms, AR1, RW2, a Matérn term on 200 points) through
   gaussian_approximation on the kernels against the plain path.

Every kernel's launch counter is zeroed just before each main path (phases
4-5, the flagship; 7-8, the spatial slice; 9, 10 and 11) and read after
it, and so before and after each of the paths 12, 13, 13b, 14, 15, 16, 17, 18,
19, 20, 21, 22 and 23, and each of phase 24's five, phase 25's six, phase 26's five, phase 27's four and
phase 28's (b)-(d);
a kernel of the path that was never launched fails the run. Each phase's
seconds are printed when the next begins. The line before the last is one
JSON object with the kernels' launches, errors, times and bounds; the last
line is the result object. Needs no network and imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import struct
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
# float64: both sides are exact up to rounding order. float32: K1 and K2 run
# segmented scans that replay the sequential recurrences inside segments of
# at most 16 rows, from carry-ins composed over at most ~21 scaled products,
# and K3 the sequential recurrence, while the plain versions run doubling
# scans over every row (normalized Möbius products for the pivots); over
# n=500 steps the rounding of the two differs by up to ~n·eps.
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
# terms, and fct_init is a few products per entry: 1e-5. K8's first entry
# (C and A, formed in float64 on the card and in the working type by the
# plain version) is held to K8's limits, and K8 itself runs on the kernel's
# C and A.
SN_TOL = {
    torch.float64: {"gather_segsum": 1e-10, "fct_init": 1e-10, "sn_panel": 1e-10, "logdet": 1e-10,
                    "sn_trsv": 1e-10, "sn_takahashi_prep": 1e-10, "sn_takahashi": 1e-10},
    torch.float32: {"gather_segsum": 1e-5, "fct_init": 1e-5, "sn_panel": 1e-3, "logdet": 1e-4,
                    "sn_trsv": 1e-4, "sn_takahashi_prep": 5e-3, "sn_takahashi": 5e-3},
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
# K9 and K10 at B=1, n=900 and n=1000 (the dense backend's shapes of phases 15 and 16) and n=4096 (DENSE_MAX_N)
DENSE_SHAPES = ((30, 30), (40, 25), (64, 64))

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
    "sn_takahashi_prep": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1004"),
    "sn_takahashi": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1000"),
    "dense_chol": ("tpu_gmrf_torch/csrc/dense.cu", "tpu_gmrf/solvers/dense.py:102"),
    "dense_trsv": ("tpu_gmrf_torch/csrc/dense.cu", "tpu_gmrf/solvers/dense.py:47"),
    "dense_selinv": ("tpu_gmrf_torch/csrc/dense.cu", "tpu_gmrf/solvers/dense.py:74"),
    "bt_factor": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:354"),
    "bt_trsv": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:145"),
    "sn_multiply": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1287"),
    # the transpose products: JAX's AD of sqrt_matvec (no kernel of its own there)
    "sn_multiply_t": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1287"),
    "bt_matvec": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:297"),
    "bt_sqrt": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:272"),
    "bt_sqrt_t": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:272"),
    "bsr_spmm": ("tpu_gmrf_torch/csrc/bsr.cu", "tpu_gmrf/kernels/bsr_spmv.py:182"),
    "bsr_outer": ("tpu_gmrf_torch/csrc/bsr.cu", "tpu_gmrf/kernels/bsr_spmv.py:215"),
    "kl_columns": ("tpu_gmrf_torch/csrc/kl.cu", "tpu_gmrf/kl_cholesky.py:116"),
    "block_inv": ("tpu_gmrf_torch/csrc/block_inv.cu", "tpu_gmrf/graphical_lasso.py:150"),
    "bt_factor_blocks": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/parallel/pbtridiag.py:53"),
    "bt_trsv_blocks": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/parallel/pbtridiag.py:76"),
    "spike_reduced": ("tpu_gmrf_torch/csrc/spike.cu", "tpu_gmrf/parallel/pbtridiag.py:100"),
    # the tangents: JAX's AD of the reference's selected inverse (no kernel of its own there)
    "tridiag_selinv_tangent": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/tridiag.py:70"),
    "sn_panel_tangent": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1345"),
    "sn_takahashi_tangent": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:1345"),
    "bt_factor_tangent": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:209"),
    # the adjoints: JAX's AD (reverse mode) of the reference's factorizations (no kernel of its own there)
    "tridiag_factor_adjoint": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/tridiag.py:102"),
    "bt_factor_adjoint": ("tpu_gmrf_torch/csrc/banded.cu", "tpu_gmrf/solvers/banded.py:376"),
    "sn_panel_adjoint": ("tpu_gmrf_torch/csrc/supernodal.cu", "tpu_gmrf/solvers/supernodal.py:907"),
}
FLAGSHIP_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "csr_spmv", "gather_segsum")
SPATIAL_KERNELS = ("csr_spmv", "gather_segsum", "fct_init", "sn_panel", "sn_trsv", "sn_takahashi_prep", "sn_takahashi")
# The NUTS paths factor and differentiate the supernodal prior (K5, K6, K8)
# but never solve with it, so K7 is not on them; the inner solver is K9/K10
# at g=16 and K11/K12 at n=5741.
SPATIAL_NUTS_KERNELS = ("csr_spmv", "gather_segsum", "fct_init", "sn_panel", "sn_takahashi_prep", "sn_takahashi")
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
              "sn_trsv", "sn_takahashi_prep", "sn_takahashi")
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
# K17 and K16's warp path (cap ≤ 32) against their plain versions: both round every operation once in the
# same order, so they agree to the bit (the first readings on the H100: 0 in f64 and f32); the limits below
# hold them, with the NaN masks of kernel and plain required equal. K16's tile and cluster paths factor by
# tiles of 64 with fused multiply-adds and inverted tiles, another order of rounding; the blocks' condition
# reaches ~1/jitter, and another correct order (cholesky_ex + solve_triangular on the CPU) lands up to 8.9e-12
# (f64) and 5.9e-3 (f32) from the plain version on example 09's n = 10,000 buckets. So those paths are held,
# bucket by bucket, to what does not depend on the order: (a) the largest backward error of a column,
# ‖A x − e_N / x_N‖_∞ / (‖A‖_∞ ‖x‖_∞) (A x = L_NN e_N and x_N = 1 / L_NN), at most 4x the plain version's
# plus N ε; (b) the distance from the plain version (max |kernel − plain| / max |plain|) at most 4x that of
# the library's order (kl_library) from it; (c) equal NaN masks. A wrong column has a backward error of
# order 1. The KL and glasso paths against their plain paths, f64:
# Q's data 1e-9 (the KL path's plain run is on CPU tensors, whose exp and sqrt in the cov_fn differ from
# the card's in the last bit, and each column's solve amplifies that by its block's condition, up to
# ~1/jitter: the first readings on the H100 were 3.6e-13 at n=900 and 1.1e-11 at n=10,000; on the card
# the glasso's Q is K5's sums in another order); logdet 1e-10; var, conditional means and logpdf 1e-8 (the
# dense and supernodal Choleskys of a precision of condition up to ~1e8 round in another order).
KL_FACTOR = 4  # (a) and (b) above
SN_TOL[torch.float64].update(kl_columns=1e-12, block_inv=1e-10)
SN_TOL[torch.float32].update(kl_columns=1e-4, block_inv=1e-3)
PATH_TOL = {"data": 1e-9, "logdet": 1e-10, "stat": 1e-8}


# Phases 3f and 17: the SPIKE solve (tpu_gmrf/parallel/pbtridiag.py) at full width, Q = Q_t ⊗ Q_s: Q_t the
# AR1Model precision over Nt = 128 steps (τ = 1, ρ = 0.9), Q_s the Matérn α=2 precision on the g=16 mesh
# (ns = 450 at τ = 1, range 0.25: the dense backend's shape of phase 10), in P = 4 chunks of 32 slices, f64:
# diag[t] = Q_t[t, t]·Q_s, sub[t] = Q_t[t+1, t]·Q_s. Example 12 part 3 (examples/12_multichip_sharding.py:
# 104-134) as written: P = 8, Nt = 4P, ns = 8, f32, seed 3, with its own limits.
SPIKE_NT, SPIKE_P, SPIKE_RHO = 128, 4, 0.9
# Phase 17's check against the supernodal solve of the assembled Q runs at Nt = 32 (n = 14,400), the SPIKE solve
# at that Nt in the same P chunks: at Nt = 128 (n = 57,600, 77 M entries) the check took 154 s (assembly 20.4 s,
# plan + factor + solve 133.8 s) of a 1064.9 s script, 135 s inside its 1200 s limit, on the H100.
SPIKE_ORACLE_NT = 32
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


# Phase 19: constrained Laplace. bench_micro's GA row (bench.py:395-406): RW1Model(500), Poisson counts
# rng(1).poisson(1.0, 500), GAOptions(max_iter=25), here with 256 chains whose τ is log-spaced over [0.5, 2];
# RW2Model(500) (two constraints; auto -> dense, K9/K10) with 8 chains in float64. The float64 kernel path is
# held to the float64 plain path (CPU tensors) with SLICE_TOL's f64 bounds. RW1 + its 1e-5 ridge has a prior
# condition near 1e5-1e6, so the float32 logdet is rounding-limited whatever computes it: the float32 kernel
# path is held to at most CON_F32_FACTOR times the float32 plain path's distance from the float64 plain path
# (the same inputs, CPU tensors) plus CON_F32_FLOOR, a bound that describes the problem, not the port; both
# readings are printed. Every chain's mode satisfies A x* = e to CON_CONSTRAINT_TOL (float64).
CON_N, CON_CHAINS, CON_RW2_CHAINS = 500, 256, 8
CON_F32_FACTOR, CON_F32_FLOOR, CON_CONSTRAINT_TOL = 2.0, 1e-6, 1e-6
CON_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "csr_spmv", "gather_segsum", "dense_chol",
               "dense_trsv", "dense_selinv")
# Phase 20: example 08's areal workload (examples/08_factorization_reuse.py: BesagModel on the 100x100 grid
# adjacency, N = 10,000; BASELINE.md:20). Besag + Poisson value+grad over 4 chains (τ 0.5-2, counts from a
# smooth log-rate field, seed 8) and BYM2 (n = 20,000) logpdf with its (τ, φ) gradient over 4 chains, float64,
# against the plain path on CPU tensors with SLICE_TOL's f64 bounds; then example 08's τ-profile: 50 τ in
# [0.5, 2] through make_workspace_pool(...).batch_evaluate(..., batch_size=10), float32 as the example runs it
# and float64, held to the example's anchor (examples/08_factorization_reuse.py:86-103, tools/golden_values.py:249:
# q = zᵀQ(1)z = 41329.223752, c1 = (N-1)/2, |Δlp − pred| ≤ 2.0 + 2.5e-3·|pred|, argmax at the first τ) and its
# first 4 τs against a fresh model(tau=t).logpdf(z) each, rtol 2e-4 (its line 80).
AREAL_GRID, AREAL_CHAINS = 100, 4
EX08_TAUS, EX08_BATCH, EX08_Q = 50, 10, 41329.223752
EX08_LIMITS = {"abs": 2.0, "rel": 2.5e-3, "cold": 2e-4}
# the backend's kernels are added to these once `auto` has resolved (banded: K11/K12; supernodal: K5-K7)
AREAL_KERNELS = ("csr_spmv", "gather_segsum", "sn_takahashi_prep", "sn_takahashi")
BACKEND_KERNELS = {"banded": ("bt_factor", "bt_trsv"), "supernodal": ("fct_init", "sn_panel", "sn_trsv"),
                   "dense": ("dense_chol", "dense_trsv")}
# Phase 21: examples 01, 02 and 05 with their seeded inputs copied exactly, float32 as the examples run and
# float64, held to their golden literals (value, limit, where): the literals are scipy float64 oracles
# (tools/golden_values.py), so the card needs no JAX. Example 05's forecast RMSE is not held: its x is the
# JAX package's draw (examples/05_autoregressive_models.py:27, tools/golden_values.py:210), and the port's
# draws differ; what does not depend on x is held (the two bands, the AR1 interior variance).
GOLDEN = {
    "ex01 AR1 rmse": (0.078080, 2e-3, "examples/01_getting_started.py:49, tools/golden_values.py:35"),
    "ex01 AR1 mean std": (0.723701, 5e-3, "examples/01_getting_started.py:50, tools/golden_values.py:35"),
    "ex01 Matern fit rmse": (0.004299, 2e-3, "examples/01_getting_started.py:70, tools/golden_values.py:58"),
    "ex01 Matern mean std": (0.494114, 1e-2, "examples/01_getting_started.py:71, tools/golden_values.py:58"),
    "ex02 fit rmse": (0.021820, 2e-3, "examples/02_spatial_modelling_spdes.py:56, tools/golden_values.py:169"),
    "ex02 oos rmse": (0.102026, 8e-3, "examples/02_spatial_modelling_spdes.py:57, tools/golden_values.py:169"),
    "ex02 mean std": (0.497823, 5e-3, "examples/02_spatial_modelling_spdes.py:58, tools/golden_values.py:169"),
    "ex05 band[150]": (1.002574, 1e-2, "examples/05_autoregressive_models.py:55, tools/golden_values.py:199"),
    "ex05 band[-1]": (2.649064, 3e-2, "examples/05_autoregressive_models.py:56, tools/golden_values.py:199"),
}
EXAMPLE_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "csr_spmv", "gather_segsum", "dense_chol",
                   "dense_trsv", "dense_selinv")
# Phase 22: observation breadth. (a) Example 03 (examples/03_bernoulli_spatial_classification.py: Bernoulli marks
# through the FEM evaluation matrix, η = A x) at the spatial slice's size: phase 7's model (Matérn α=2 on the
# 63x63 grid, n = 5741, supernodal inner solver, SP_GA_ITER Newton iterations), the marks at the 3969 grid nodes
# drawn with seed 1 from sigmoid(sin 3x · cos 2y), 4 chains at phase 7's θ. Each dtype is held to its own plain
# path (the same code on CPU tensors, the same inputs): float64 is exact up to rounding order, so SP_SLICE_TOL's
# f64 bounds, as phase 7. In float32 the Matérn prior's scaled condition, far above 1/eps(f32), amplifies every
# summation order (the f32 gradient is ~15% from float64 in both packages, ROADMAP §3, so float32 is not held to
# float64), and with these observations more than with phase 7's: on the H100 the f32 kernel path read value
# 2.0e-4 and gradient 4.8e-2 from the f32 plain path, past phase 7's f32p bounds (1.2e-4, 1.2e-2), while its f64
# path agreed to 1.8e-11 and 1.7e-9. So float32 is held as phase 19 holds its float32 slice, by a bound that
# describes the problem, not the port: its distance from the f32 plain path at most EX03_F32_FACTOR times the
# f32 plain path's own distance from the f64 plain path, plus EX03_F32_FLOOR; every reading is printed.
# (b) A non-canonical link at the
# flagship's shape: AR1Model(500), 256 chains, float32, normal observations under the log link, σ = 0.3,
# y = exp(x_true) + 0.3 ε with x_true one AR1 draw at τ = 4, ρ = 0.9 (seed 4), against the f64 plain path with
# SLICE_TOL's bounds. From laplace_marginal's start, the prior mean 0, no chain converges in either package:
# d²ℓ/dη² = μ(y − 2μ)/σ² reaches ~+2.8e2 where y ≈ 26 > 2μ = 2, against the prior's diagonal τ(1 + ρ²), so the
# first Q_post is indefinite and every chain exits non-finite; the grid's other non-canonical pairs
# (poisson/identity, gamma/identity) are undefined at η = 0 (log 0). So Newton starts where the data put it,
# x0 = log(max(y, NC_X0_FLOOR)), by gaussian_approximation(x0=) and marginal_loglikelihood, as the grid's own
# Laplace test starts from a feasible point; the phase prints the zero start's finite chains too. (c) Example 03
# at its own size (150 sites, the default inner solver), float32 and float64, held to its literals.
EX03_F32_FACTOR, EX03_F32_FLOOR = 2.0, 1e-6
EX03_GOLDEN = {"mode norm": (31.958964, 0.3), "mean std": (1.026679, 0.02), "accuracy": (0.80, 2.0 / 150 + 1e-9)}
NC_SIGMA, NC_TAU, NC_RHO, NC_SEED, NC_X0_FLOOR = 0.3, 4.0, 0.9, 4, 0.05
OBS_KERNELS = SPATIAL_KERNELS + ("tridiag_factor", "tridiag_solve", "tridiag_selinv")
# Phase 23: a non-Gaussian prior. (a) The robust random walk of tests/test_nongaussian_priors.py:55-73 at the
# flagship's width: StructuredLatentPrior over n = 500, Student-t increments (ν = 4) on (i, i+1) and the weak anchor
# group, log_tau per chain over 256 chains, Poisson observations (flagship_y()), marginal_loglikelihood and its
# log_tau-gradient, float32 against the f64 plain path with SLICE_TOL's f32 bounds and float64 with its f64 bounds.
# log_tau spans [-0.5, 1.0]: the Student-t log-density is concave in an increment d only while τ²d² < ν, and past
# log τ ≈ 1.4 the local quadratic of the prior at the flagship's increments is indefinite, so Newton's factor
# breaks down and those chains exit non-finite (on CPU tensors: 244 of 256 finite over [-1, 1.5], 142 over
# [0, 2.5]). The posterior pattern is tridiagonal, so auto -> tridiag (K1-K3; K4 in h = ∇log p + Q x, K5 in the
# factor scatters and Q − H). (b) The same log-density as one function for AutoDiffLatentPrior on the tridiagonal
# SparsePattern (sparse_hessian_map, 3 colours) at ST_AD_CHAINS of (a)'s log_tau, float64: its mode, marginal and
# gradient equal to the structured prior's to ST_AD_TOL (the same arithmetic by another autodiff route).
ST_NU, ST_LOG_TAU, ST_AD_CHAINS, ST_AD_TOL = 4.0, (-0.5, 1.0), 8, 1e-10
ST_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "csr_spmv", "gather_segsum")
# Phase 3g: the selected inverse's tangents K19-K22 against their plain versions, per launch on the same inputs:
# K19 at the flagship's shape, B = 256, n = 500; K20 and K21 over the whole supernodal schedule of phase 3b's
# posterior (n = 5741, B = 4); K22 and K21 on the banded blocks of the same size (phase 11's configuration).
# K20-K22 compute in float64 for both types, and their plain versions are run in float64 on the kernels' inputs;
# K19 replays in the chains' type, as its plain version does. float64: 1e-10 normwise, and Σ̇ at Q's pattern
# within 1e-8 of −P(Σ·T·Σ) from a dense inverse. float32: TANGENT_F32, K19's as K1-K3's (KERNEL_TOL), K20-K22's
# above the first readings on the H100 (3.3e-8, 2.5e-8, 3.9e-8, K21 banded 3.7e-8: their outputs' rounding).
TANGENT_F32 = {"tridiag_selinv_tangent": 1e-4, "sn_panel_tangent": 1e-5, "sn_takahashi_tangent": 1e-5,
               "sn_takahashi_tangent_banded": 1e-5, "bt_factor_tangent": 1e-5}
SN_TOL[torch.float64].update({k: 1e-10 for k in TANGENT_F32}, sigma_tangent=1e-8)
SN_TOL[torch.float32].update(TANGENT_F32)
# Phase 24: the θ-Hessians (one gradient with create_graph=True, then a backward pass per component) of the
# flagship (AR1(500) + Poisson, 256 chains at phase 4's θ read as (log τ, atanh ρ), max_iter=25, f64 and f32),
# of example 13 on the card (its own checks and limits, f32), of the spatial slice (phase 7's model and counts, 4
# chains, f64; supernodal, then with the model's solver and the inner one auto -> banded) and of the g=16 slice (8
# chains, both auto -> dense, f64), each held against the f64 plain path on CPU tensors ("plain", per chain, normwise), for symmetry
# ("sym") and against central differences of the kernel path's own gradient ("cd"); the Hessian of GMRF.logpdf
# through K4 at AR1(500) against −Q (fault 3.4); d/dθ of Σ var_i at n=14058 against a central difference.
# f64 against the f64 plain path and for symmetry: both sides run the same Newton loop with the same stop, so
# what parts them is rounding; the limits sit two to three decades above the readings on the H100 (flagship
# 1.7e-13 and 2.2e-14; spatial supernodal 3.1e-10 and 2.0e-11, banded 1.1e-9 and 1.7e-10; g=16 6.7e-12 and
# 4.2e-13). Central differences are held about ten times above their first readings (f64 flagship at h=1e-3
# 4.5e-6; spatial and g=16 2.3e-7 and 1.1e-6), as are the f32 flagship's (plain 8.1e-5, asymmetry 6.5e-6,
# differences at h=1e-2 5.1e-3). Σ var_i's gradient at n=14058 read 5.7e-7 from its difference at h=1e-4, the
# difference's own rounding (Q's condition near 1e8 on this grid).
HESS_TOL = {"f64": {"plain": 1e-10, "sym": 1e-11, "cd": 1e-4}, "f32": {"plain": 1e-3, "sym": 1e-4, "cd": 5e-2},
            "spatial": {"plain": 1e-7, "sym": 1e-8, "cd": 1e-5}, "g16": {"plain": 1e-9, "sym": 1e-10, "cd": 1e-5},
            "logpdf": 1e-12, "var_cd": 1e-5}
HESSIAN_FLAGSHIP_KERNELS = FLAGSHIP_KERNELS + ("tridiag_selinv_tangent",)
HESSIAN_EX13_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "tridiag_selinv_tangent")
HESSIAN_SPATIAL_KERNELS = SPATIAL_KERNELS + ("sn_panel_tangent", "sn_takahashi_tangent")
# the banded and dense cells: the model's own solver auto as well, so that the logdets' Σ (and Σ̇) are the banded
# (K8, K22, K21) and dense (K10's entries) ones; the prior of phases 10-11 stays supernodal
HESSIAN_BANDED_KERNELS = ("csr_spmv", "gather_segsum", "sn_takahashi_prep", "sn_takahashi", "bt_factor", "bt_trsv",
                          "bt_factor_tangent", "sn_takahashi_tangent")
HESSIAN_DENSE_KERNELS = ("csr_spmv", "gather_segsum", "dense_chol", "dense_trsv", "dense_selinv")
HESSIAN_VAR_KERNELS = ("fct_init", "sn_panel", "sn_takahashi_prep", "sn_takahashi", "gather_segsum",
                       "sn_panel_tangent", "sn_takahashi_tangent")

# Phase 3h: the factorizations' adjoints K23-K25 (the cotangent of Q from that of its factor L) and the transpose modes
# of K13's second entry and K7, against their plain versions on the same inputs: K23 at the flagship's shape
# (B = 256, n = 500), K24 on phase 11's banded blocks (n = 5741, B = 4, K = 12, s = 512), K25 launch by launch over
# phase 3b's supernodal schedule, the transpose modes at k = 16, 1 and 40 on those factors (each one launch a product,
# two launches equal bit for bit; K7's mode 3 also at phase 14's shape, B = 1, n = 14058); the plain versions in
# float64 on the kernels' inputs. float64: 1e-12 normwise. float32: K24, K25 and K7's transpose mode compute in
# float64 and round once on the way out, K23 replays its recurrence in float32 (as K19 does) and K13's transpose
# mode sums in float32;
# the limits sit above the rounding that implies (K23 read 7.8e-8 against the float64 plain version on the H100).
ADJOINT_F32 = {"tridiag_factor_adjoint": 1e-5, "bt_factor_adjoint": 1e-5, "sn_panel_adjoint": 1e-5, "bt_sqrt_t": 1e-5,
               "sn_multiply_t": 1e-5}
# right-hand sides per chain of the transpose products' checks: all of a chain's in one pass (16, 1), and in three
# (40: bt_sqrt_t's later passes, each streaming the slab again; sn_multiply_t's later chunks)
TRANSPOSE_KS = (16, 1, 40)
BT_WIDE_S = 3000  # bt_sqrt_t's blocks in phase 3h's wide check: above every phase's s (a slab of 1,504 rows)
SN_TOL[torch.float64].update({k: 1e-12 for k in ADJOINT_F32})
SN_TOL[torch.float32].update(ADJOINT_F32)
# Phase 25: pathwise gradients through the factor: θ ↦ (1/k) Σ_k f(μ + L⁻ᵀz_k) per chain, f the Poisson log-likelihood
# of the cell's counts, k = 16 draws through GMRF.sample with a generator on the card, (a) on the flagship (AR1(500),
# 256 chains at phase 4's θ, (log τ, atanh ρ)), (b) on the spatial prior at n = 5741 (4 chains, (log τ, log range);
# supernodal and auto -> banded), plus Σ w·(L zq) of sqrt_matvec in θ and zq, (c) at g = 16 (8 chains, auto ->
# dense); each against the f64 plain path (the same noise, CPU tensors) and a central difference at h = 1e-4 at the
# fixed noise. float64 against the plain path: the flagship 1e-10; the spatial cells 1e-8 (factorizations of a prior
# of scaled condition near 1e8 in two orders; on the H100 the solves read 1e-13 and K24's whole adjoint 2e-12 from
# the plain path). Central differences: the flagship 1e-6; the spatial cells 2e-6, above their readings on the H100
# at h = 1e-4 (1.2e-7 supernodal, 5.0e-7 banded, 1.3e-8 g=16) and on CPU tensors (the n = 5741 gradient 6.9e-7 from
# its difference at h = 1e-3 and 1e-4 alike, as is torch's own Cholesky backward on the densified matrix: the f64
# function's conditioning, not the derivative). float32: at most twice the f32 plain path's own distance from the
# f64 plain path, plus 1e-6, the bound that describes the problem as phases 19 and 22 hold theirs; on the flagship
# the plain path on CPU tensors; on the spatial prior, per chain, the plain path on the card (the plain versions on
# the same card inputs): there the card's f32 factorization, the kernels' and the plain versions' alike, breaks
# down on the chain of the largest range (two boosted pivots, f64's smallest scaled pivot 7.2e-5) where the CPU's
# does not, and its other chains sit further from f64 than the CPU's (ROADMAP §3); a boosted chain's gradient is
# that of the boosted factor, so those chains are not held, the kernels are required to boost the chains the plain
# versions boost, and the other chains are held. (d) The
# flagship's mean over 64 chunks of 16 draws of ∂/∂θ Σ x_i² against ∂/∂θ Σ var_i (SelectedInverse): within 5 Monte
# Carlo standard errors at every (chain, θ) pair. (e) SPIKE at phase 17's shape: the logdet's directional derivative
# against a five-point central difference at h = 1e-5 along a random direction (1e-6), `_Ranks` on a one-rank NCCL
# mesh against `_Chunks` (1e-9), the solve's Hessian-vector product against the f64 plain path (1e-9).
PATH_DRAWS, PATHWISE_H, SPIKE_CD_H, MC_CHUNKS, MC_DRAWS = 16, 1e-4, 1e-5, 64, 16
PATHWISE_TOL = {"f64": 1e-10, "spatial": 1e-8, "cd": 1e-6, "cd_spatial": 2e-6, "f32_factor": 2.0, "f32_floor": 1e-6,
                "mc": 5.0, "spike_cd": 1e-6, "ranks": 1e-9, "hvp": 1e-9}
PATHWISE_FLAGSHIP_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_factor_adjoint")
PATHWISE_SN_KERNELS = ("fct_init", "sn_panel", "sn_trsv", "sn_multiply", "sn_multiply_t", "sn_takahashi_prep",
                       "sn_panel_adjoint", "gather_segsum")
PATHWISE_BANDED_KERNELS = ("bt_factor", "bt_trsv", "bt_sqrt", "bt_sqrt_t", "sn_takahashi_prep", "bt_factor_adjoint",
                           "gather_segsum")
PATHWISE_DENSE_KERNELS = ("dense_chol", "dense_trsv")
PATHWISE_MC_KERNELS = ("tridiag_factor", "tridiag_solve", "tridiag_selinv", "tridiag_factor_adjoint",
                       "tridiag_selinv_tangent")
PATHWISE_SPIKE_KERNELS = ("bt_factor_blocks", "bt_trsv_blocks", "spike_reduced", "sn_takahashi_prep", "sn_takahashi")


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


def spd_rows(rng, B: int, n: int):
    """B random SPD tridiagonal rows (a (B, n), c (B, n-1)), diagonally dominant."""
    c = rng.normal(size=(B, n - 1))
    a = np.abs(rng.normal(size=(B, n))) + 0.5
    a[:, 1:] += np.abs(c)
    a[:, :-1] += np.abs(c)
    return a, c


def nan_rel_err(got, ref) -> float:
    """Normwise relative error over the finite entries of matching tensors,
    after requiring their NaN masks to be equal (inf is compared as a value)."""
    err, scale = 0.0, 0.0
    for g, r in zip(got, ref):
        if r.numel() == 0:
            continue
        if not torch.equal(torch.isnan(g), torch.isnan(r)):
            raise AssertionError("the kernel's NaN positions differ from the plain version's")
        ok = ~torch.isnan(r)
        g, r = g[ok].double(), r[ok].double()
        if r.numel():
            same = g == r  # equal infinities
            err = max(err, float(torch.where(same, 0.0, (g - r).abs()).max()))
            scale = max(scale, float(r.abs().max()))
    return err / max(scale, 1e-300)


SCAN_NS = (1, 2, 31, 32, 33, 129, 500, 1025, 2049, 8193, 20000)  # K1-K3's segment, warp, row and tile edges


def check_scan_edges(dtype, dev) -> None:
    """K1, K2 and K3 against their plain versions at the edges of the segmented
    scan (kernels.scan_launch: one warp to 16 warps a chain, 1 to 16 rows a
    thread, tiles past 8192 rows), KERNEL_TOL; a batch with one clearly negative
    pivot in a middle segment (K3 on its d: NaN at the same rows as the plain
    version, finite above the pivot); the near-singular RW1 + ridge chain."""
    from tpu_gmrf_torch import kernels

    rng = np.random.default_rng(14)
    tol, name_t = KERNEL_TOL[dtype], dtype_name(dtype)
    for n in SCAN_NS:
        worst, checks = {}, 0
        for B in (1, 3, CHAINS):
            a, c = (torch.tensor(v, dtype=dtype, device=dev) for v in spd_rows(rng, B, n))
            got, ref = kernels.tridiag_factor(a, c), kernels.tridiag_factor_plain(a, c)
            worst["K1"] = max(worst.get("K1", 0.0), nan_rel_err(got, ref))
            d, e, _ = ref
            worst["K3"] = max(worst.get("K3", 0.0), nan_rel_err(kernels.tridiag_selinv(d, e),
                                                                kernels.tridiag_selinv_plain(d, e)))
            for k in (1, 3, 64):
                if B == CHAINS and k == 64 and n > N:
                    continue  # 256 chains x 64 columns x 20,000 rows is 2.6 GB in float64; k=64 at B=1, 3
                b = torch.tensor(rng.normal(size=(B, n) if k == 1 else (B, n, k)), dtype=dtype, device=dev)
                for mode in (kernels.SOLVE_L, kernels.SOLVE_LT, kernels.SOLVE_BOTH):
                    err = nan_rel_err((kernels.tridiag_solve(d, e, b, mode),),
                                      (kernels.tridiag_solve_plain(d, e, b, mode),))
                    worst[f"K2 mode {mode}"] = max(worst.get(f"K2 mode {mode}", 0.0), err)
                    checks += 1
        torch.cuda.synchronize()
        warps, rows = kernels.scan_launch(n)
        log(f"  scan edges {name_t} n={n} ({warps} warp(s) a chain, {rows} rows a thread, "
            f"{-(-n // (32 * warps * rows))} tile(s)), B=1, 3, {CHAINS}, K2 at k=1, 3, 64: max rel "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {tol:.0e}; {checks} K2 checks)")
        if not all(v <= tol for v in worst.values()):
            raise AssertionError(f"K1-K3 disagree with their plain versions at n={n} {name_t}: {worst}")
    # a clearly negative pivot in a middle segment of chain 1: NaN logdet there only
    for n in (N, SCAN_NS[-1]):
        for B in (3, CHAINS):
            a_np, c_np = spd_rows(rng, B, n)
            mid = n // 2
            c_np[1, mid - 1] = 3.0 * np.sqrt(a_np[1, mid - 1] * a_np[1, mid])
            a, c = (torch.tensor(v, dtype=dtype, device=dev) for v in (a_np, c_np))
            got, ref = kernels.tridiag_factor(a, c), kernels.tridiag_factor_plain(a, c)
            nan_chains = torch.isnan(got[2]).nonzero().flatten().tolist()
            err = nan_rel_err(got, ref)
            log(f"  negative pivot at row {mid} of chain 1, {name_t} n={n} B={B}: NaN logdet on chains {nan_chains} "
                f"(plain {torch.isnan(ref[2]).nonzero().flatten().tolist()}), d NaN at {int(torch.isnan(got[0]).sum())} "
                f"rows (plain {int(torch.isnan(ref[0]).sum())}), finite entries max rel {err:.3e} (tol {tol:.0e})")
            if nan_chains != [1] or not bool(torch.isnan(ref[2][1])) or not err <= tol:
                raise AssertionError(f"K1 on a negative pivot, n={n} B={B} {name_t}")
            # K3 on that factor: NaN from the highest NaN pivot down, as the plain version; finite above it
            z, zp = kernels.tridiag_selinv(*ref[:2]), kernels.tridiag_selinv_plain(*ref[:2])
            err3 = nan_rel_err(z, zp)
            top = int(torch.isnan(ref[0][1]).nonzero().max())
            above = all(bool(torch.isfinite(t[1, top + 1:]).all()) for t in z)
            log(f"  K3 on that factor: zdiag NaN at {int(torch.isnan(z[0]).sum())} rows (plain "
                f"{int(torch.isnan(zp[0]).sum())}), finite above row {top} {above}, finite entries max rel {err3:.3e}")
            if not above or not err3 <= tol:
                raise AssertionError(f"K3 on a negative pivot, n={n} B={B} {name_t}")
    # RW1 + a ridge: the pivots decay towards the ridge. float32 takes 1e-5: 2 + 1e-8 rounds to 2 in
    # float32, which makes the chain exactly singular whatever factors it.
    ridge = 1e-8 if dtype == torch.float64 else 1e-5
    for n in (64, N):
        a_np = np.full((1, n), 2.0) + ridge
        a_np[:, 0] = a_np[:, -1] = 1.0 + ridge
        a = torch.tensor(a_np, dtype=dtype, device=dev)
        c = torch.full((1, n - 1), -1.0, dtype=dtype, device=dev)
        got, ref = kernels.tridiag_factor(a, c), kernels.tridiag_factor_plain(a, c)
        d64 = kernels.tridiag_factor_plain(a.double(), c.double())[0]  # the same chain factored in float64
        z = kernels.tridiag_selinv(*got[:2])  # K3 on the kernel's factor
        finite = all(bool(torch.isfinite(t).all()) for t in got + z)
        err3 = nan_rel_err(z, kernels.tridiag_selinv_plain(*got[:2]))
        far = [float((d.double() / d64 - 1).abs().max()) for d in (got[0], ref[0])]
        log(f"  RW1 + ridge {ridge:g}, {name_t} n={n}: kernel finite {finite}, last pivot d {got[0][0, -1].item():.6e} "
            f"(plain {ref[0][0, -1].item():.6e}, float64 {d64[0, -1].item():.6e}), logdet {got[2].item():.9e} (plain "
            f"{ref[2].item():.9e}); d's max rel distance from the float64 factor: kernel {far[0]:.3e}, plain {far[1]:.3e}; "
            f"K3 on the kernel's factor: zdiag[0] {z[0][0, 0].item():.6e}, max rel from plain {err3:.3e}")
        if not finite:
            raise AssertionError(f"K1 or K3 on the near-singular RW1 chain, n={n} {name_t}: not finite")
        if not err3 <= tol:
            raise AssertionError(f"K3 on the near-singular RW1 chain, n={n} {name_t}: {err3:.3e} from plain")
        if dtype == torch.float32 and not far[0] <= far[1]:
            raise AssertionError(f"K1 on the near-singular RW1 chain, n={n} f32: further from the float64 factor "
                                 f"than the plain version")


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
          cost=None, library_ms=None, shape="", op_dtype=None):
    torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{name}: non-finite kernel output")
    abs_err, rel = rel_err(got, ref)
    tol = SN_TOL[dtype][tol_key]
    bnd = bound(*cost, op_dtype or dtype) if cost is not None else None
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


def live_shape(c) -> tuple:
    """(ns, m), float arrays: each supernode's live width and live row count in class batch c, read off its
    panel table (padding points at the DUMMY slot)."""
    pan, W = c["panel"].cpu().numpy(), c["W"]
    ns = (pan[:, np.arange(W), np.arange(W)] != c["dummy"]).sum(1)
    m = (pan[:, W:, 0] != c["dummy"]).sum(1) if c["M"] else np.zeros(len(pan), np.int64)
    return ns.astype(float), m.astype(float)


def sn_costs(levels, B: int, el: int, nnz: int, nnzL: int, n: int) -> dict:
    """(operations, bytes) of a whole factorization (K6), solve (K7) and
    Takahashi sweep (K8's first entry and K8) over the schedule's class
    batches, from each supernode's live width ns and live row count m
    (Cholesky ns³/3, panel solve m·ns², update m²·ns; K8's first entry: the
    triangular inverse ns³/3, C = Lb·Ld⁻¹ m·ns², A = Ld⁻ᵀLd⁻¹ (lower) ns³/3;
    K8: Σ_RJ 2m²·ns, Σ_JJ (lower) m·ns²; the K5 reductions between levels, a
    few percent of the work, are not counted) and the bytes of the values
    and the class tables the steps read."""
    shapes, tabs = [], {k: 0 for k in ("panel", "cols", "rows", "schur")}
    for lv in levels:
        for c in lv.classes:
            shapes.append(live_shape(c))
            for k in tabs:
                tabs[k] += c[k].numel() * 4
    ns, m = (np.concatenate(a) for a in zip(*shapes))
    return {
        "sn_panel": (B * float(np.sum(ns**3 / 3 + m * ns**2 + m**2 * ns)),
                     el * B * (nnz + nnzL + 1) + tabs["panel"] + tabs["cols"]),
        "sn_trsv": (B * float(np.sum(2 * ns**2 + 4 * m * ns)),
                    el * B * (nnzL + 2 * n) + tabs["panel"] + tabs["cols"] + tabs["rows"]),
        "sn_takahashi_prep": (B * float(np.sum(2 * ns**3 / 3 + m * ns**2)), el * B * 2 * (nnzL + 1) + tabs["panel"]),
        "sn_takahashi": (B * float(np.sum(2 * m**2 * ns + m * ns**2)),
                         el * B * 2 * (nnzL + 1) + tabs["panel"] + tabs["schur"]),
        "sn_multiply": (B * float(np.sum(ns**2 + 2 * m * ns)),
                        el * B * (nnzL + 2 * n) + tabs["panel"] + tabs["cols"]),
    }


def sn_costs_k(cost: tuple, k: int, el: int, B: int, n: int) -> tuple:
    """K7's (operations, bytes) at k right-hand sides per chain from its cost at one: the arithmetic k times, the
    right-hand sides' reads and writes k times, the panel read once."""
    flops, nbytes = cost
    return flops * k, nbytes + el * B * 2 * n * (k - 1)


def k8_prep(vals, width: int, preps, fn):
    """C and A, in rows of `width` laid out like Σ, by K8's first entry `fn` (kernel or plain) over `preps`."""
    pre = vals.new_zeros(vals.shape[0], width)
    for c in preps:
        fn(vals, pre, c)
    return pre


def k8_sweep(pre, classes, fn):
    """Σ by K8 `fn` (kernel or plain) from C and A in `pre`, over the class batches `classes`, the last first."""
    sig = torch.zeros_like(pre)
    for c in reversed(classes):
        fn(pre, sig, c)
    return sig


def launch_count(kern, run) -> int:
    """Kernels that the wrapper `kern` launched on the card in one call of `run`."""
    before = kern.launches
    run()
    return kern.launches - before


def dense_factor(vals, meta):
    """The factor L (B, n, n) densified from its values on the fill pattern, and the pattern's (row, column) index
    tensors: position p of vals holds L[hi[p], lo[p]]."""
    from tpu_gmrf_torch.solvers import supernodal as sn

    plan = sn._PLAN_CACHE[meta]
    n, key = plan["n"], torch.as_tensor(np.asarray(plan["entry_key"], np.int64), device=vals.device)
    hi, lo = key % n, key // n
    L = vals.new_zeros(vals.shape[0], n, n)
    L[:, hi, lo] = vals[:, :-1]
    return L, hi, lo


def k8_library(vals, meta):
    """K8's library yardstick on the supernodal factor: torch.cholesky_inverse of the densified factor, then
    the gather of Σ onto L's pattern (the function K8's two entries compute), as a callable."""
    L, hi, lo = dense_factor(vals, meta)
    return lambda: torch.cholesky_inverse(L)[:, hi, lo]


def equilibrated_dense(Q, meta):
    """(A, hi, lo): the matrix the supernodal schedule factors, densified (Q symmetrized, Jacobi-equilibrated as
    fct_init does it, in the plan's permuted order), and the (row, column) index tensors of L's pattern."""
    from tpu_gmrf_torch.solvers import supernodal as sn

    plan = sn._PLAN_CACHE[meta]
    pat, data, n = Q.pattern, Q.data.reshape(-1, Q.nnz), plan["n"]

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=data.device)

    sym = 0.5 * (data + data[:, idx(pat.transpose_perm)])
    dg = sym[:, idx(pat.diag_positions)]
    one = torch.ones_like(dg)
    s = torch.where(dg > 0, torch.rsqrt(torch.where(dg > 0, dg, one)), one)
    rows, cols, ip = idx(pat.rows), idx(pat.cols), idx(plan["inv_perm"])
    A = data.new_zeros(data.shape[0], n, n)
    A[:, ip[rows], ip[cols]] = sym * s[:, rows] * s[:, cols]
    key = idx(plan["entry_key"])
    return A, key % n, key // n


def k6_library(Q, meta):
    """K6's library yardstick: torch.linalg.cholesky_ex of the matrix the schedule factors, densified
    (`equilibrated_dense`, formed here, outside the callable), then the gather onto L's pattern: the function K6's
    launches compute over the whole schedule."""
    A, hi, lo = equilibrated_dense(Q, meta)
    return lambda: torch.linalg.cholesky_ex(A).L[:, hi, lo]


def k7_library(f, b):
    """K7's library yardstick for the solve Q x = b of the supernodal factor f (b (B, n) or (B, n, k)):
    torch.cholesky_solve on the densified factor (formed here, outside the callable), with the permutation and the
    scaling applied as the factor's solve applies them (x[perm] = s[perm]·y, L Lᵀ y = (s·b)[perm])."""
    from tpu_gmrf_torch.solvers import supernodal as sn

    L, _, _ = dense_factor(f.vals, f.meta)
    perm = torch.as_tensor(np.asarray(sn._PLAN_CACHE[f.meta]["perm"], np.int64), device=b.device)
    s = f.s.reshape(L.shape[0], -1)[:, perm, None]
    rhs = b.reshape(L.shape[0], L.shape[1], -1)

    def run():
        x = torch.empty_like(rhs)
        x[:, perm] = torch.cholesky_solve(rhs[:, perm] * s, L) * s
        return x.reshape(b.shape)

    return run


def rescue_panels(c, nnzL: int, B: int, fails: dict, rng) -> np.ndarray:
    """Values (B, nnzL+1) on class batch c's panels for K6's rescue check: a unit diagonal, off-diagonals of
    0.1/ns, rows below of 0.5, column 0 coupled to nothing, and the first pivot of (supernode p, chain b) set to
    fails[(p, b)] (other positions zero)."""
    W, M = c["W"], c["M"]
    panel = c["panel"].long().cpu().numpy()
    vals = np.zeros((B, nnzL + 1))
    for p in range(panel.shape[0]):
        ns = int((panel[p, np.arange(W), np.arange(W)] != c["dummy"]).sum())
        m = int((panel[p, W:, 0] != c["dummy"]).sum()) if M else 0
        low = np.tril_indices(ns)
        for b in range(B):
            D = np.tril(rng.normal(scale=0.1 / ns, size=(ns, ns)), -1) + np.eye(ns)
            D[:, 0] = 0.0
            D[0, 0] = fails.get((p, b), 1.0)
            Bm = rng.normal(scale=0.5, size=(m, ns))
            Bm[:, 0] = 0.0
            vals[b, panel[p][low]] = D[low]
            vals[b, panel[p, W:W + m, :ns].ravel()] = Bm.ravel()
    return vals


def check_panel_rescue(fk, dtype, dev):
    """Phase 3b: K6's pivot boost on the card, on both of its paths: the one-block class batch with the most
    supernodes and the widest cluster-path batch with rows below, on rescue_panels whose first pivot is -δ/2
    (rescued by δ) or -2δ (rescued by the Gershgorin shift), δ = 2e-6 W: chain 1 fails once, chain 2 twice,
    chain 3 twice and, on a batch of several supernodes, once more on its last. Factor values, U (lower), log
    pivots and boost counts against sn_panel_plain on the same inputs."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.kernels import banded as kb
    from tpu_gmrf_torch.kernels import supernodal as ks
    from tpu_gmrf_torch.solvers import supernodal as sn

    B, n, nnzL = fk.vals.shape[0], fk.n, fk.vals.shape[1] - 1
    classes = [c for lv in sn._device_plan(fk.meta, dev)["levels"] for c in lv.classes]
    fit, sms = kb._fit("tg_sn_panel_fit", dtype, "sn_panel"), ks._sm_count(dev)
    path = {id(c): ks.panel_launch(c["W"], c["M"], c["panel"].shape[0] * B, fit, sms) for c in classes}
    one = max((c for c in classes if path[id(c)] == 0), key=lambda c: c["panel"].shape[0])
    wide = max((c for c in classes if path[id(c)] > 0 and c["M"]), key=lambda c: (c["W"], c["M"]))
    rng = np.random.default_rng(11)
    for label, c in (("one block", one), ("cluster", wide)):
        W, M, P = c["W"], c["M"], c["panel"].shape[0]
        delta = 2e-6 * W
        fails = {(0, 1): -0.5 * delta, (0, 2): -2 * delta, (0, 3): -2 * delta}
        if P > 1:
            fails[(P - 1, 3)] = -0.5 * delta
        vals = torch.tensor(rescue_panels(c, nnzL, B, fails, rng), dtype=dtype, device=dev)
        outs = []
        for fn in (kernels.sn_panel, kernels.sn_panel_plain):
            v, u = vals.clone(), vals.new_zeros(B, c["ubase"] + P * M * M + 1)
            logs, boost = vals.new_zeros(B, n), torch.zeros(B, dtype=torch.int32, device=dev)
            fn(v, dict(classes=[c]), u, logs, boost)
            U = torch.tril(u[:, c["ubase"]: c["ubase"] + P * M * M].reshape(B, P, M, M))
            outs.append(((v, U, logs), boost.tolist()))
        (got, bk), (ref, bp) = outs
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        tol = SN_TOL[dtype]["sn_panel"]
        want = [0, 1, 1, 1 + (P > 1)]
        log(f"  sn_panel forced rescue {dtype_name(dtype)}, {label} path (W={W} M={M} P={P} B={B}, cluster "
            f"{path[id(c)]}; first pivots -δ/2 and -2δ): boost kernel {bk} plain {bp} (want {want}), "
            f"max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:.0e})")
        if bk != bp or bk != want or not rel <= tol:
            raise AssertionError(f"sn_panel forced rescue, {label} path: boost {bk} / {bp}, rel {rel:.3e}")


def check_sp_add(dtype, dev, results: dict):
    """Phase 3b: K5 on `sp_add`'s plan at the flagship shape (Q_p − H, B=256, n=500: the Newton iterate's
    `_Linear`), against its plain version and the library call that computes the same function, CSR
    `torch.sparse.mm` of the plan's 0/1 matrix; its row is the kernel's row in the JSON line."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.sparse.matrix import _ADD_CACHE, sp_add, sp_tridiag, spdiag

    a, c, x, _ = kernel_inputs(dtype, dev)
    Q, H = sp_tridiag(a, c), spdiag(-x.exp())
    sp_add(Q, H)
    _, (plan, _) = _ADD_CACHE[(Q.pattern, H.pattern)]
    both = torch.cat([Q.data, H.data], -1).contiguous()
    d = plan.tensors(dev)
    with warnings.catch_warnings():  # "beta" notices of sparse CSR
        warnings.simplefilter("ignore", UserWarning)
        S = torch.sparse_coo_tensor(torch.stack([d["term_row"], d["xi_l"]]), both.new_ones(len(plan.xi)),
                                    (plan.rows, both.shape[1])).to_sparse_csr()
    bt = both.T.contiguous()
    lib = lambda: torch.sparse.mm(S, bt)  # noqa: E731
    el = both.element_size()
    check("gather_segsum sp_add (Q_p - H, _Linear)", dtype, kernels.gather_segsum(plan, both),
          kernels.gather_segsum_plain(plan, both), "gather_segsum", results,
          cuda_ms(lambda: kernels.gather_segsum(plan, both)), cuda_ms(lambda: kernels.gather_segsum_plain(plan, both)),
          cost=(CHAINS * len(plan.xi), table_bytes(plan) + el * CHAINS * (both.shape[1] + plan.rows)),
          library_ms=cuda_ms(lib), shape=f"B={CHAINS} n={N} sp_add",
          extra=f" (library: CSR torch.sparse.mm of the plan's 0/1 matrix, {rel_err((lib().T,), (kernels.gather_segsum_plain(plan, both),))[1]:.1e} from plain; "
                f"{plan.rows} rows, {len(plan.xi)} terms)")


def check_segsum_schedule(post, fk, dp, b, dtype, dev):
    """Phase 3b: K5 on every level's Schur and forward plan (one ragged plan each, a row per target) against its
    plain version, each level on its own; the schedule's launches per factorization and per solve; its time over
    all levels of a factorization and of a solve, with its bound; the one-launch sums of the logdet and of
    `selinv_dot`."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import supernodal as sn

    rng = np.random.default_rng(9)
    B, n, el = fk.vals.shape[0], fk.n, fk.vals.element_size()
    tol = SN_TOL[dtype]["gather_segsum"]
    cases = {"schur": [], "fwd": []}
    for li, lv in enumerate(dp["levels"]):
        for nm, size, width in (("schur", lv.zu, fk.vals.shape[1]), ("fwd", lv.zf, n + 1)):
            for p in getattr(lv, nm):
                u = torch.tensor(rng.normal(size=(B, size + 1)), dtype=dtype, device=dev)
                out0 = torch.tensor(rng.normal(size=(B, width)), dtype=dtype, device=dev)
                cases[nm].append((li, p, u, out0))
    worst = {}
    for nm, cs_ in cases.items():
        for li, p, u, out0 in cs_:
            got = kernels.gather_segsum(p, u, out=out0.clone(), alpha=-1.0, accumulate=True)
            ref = kernels.gather_segsum_plain(p, u, out=out0.clone(), alpha=-1.0, accumulate=True)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"gather_segsum {nm} level {li}: non-finite kernel output")
            abs_err, rel = rel_err((got,), (ref,))
            if not rel <= tol:
                raise AssertionError(f"gather_segsum {nm} level {li} {dtype_name(dtype)}: kernel disagrees with its "
                                     f"plain version ({rel:.3e})")
            if rel >= worst.get(nm, (-1.0,))[0]:
                worst[nm] = (rel, abs_err, li)

        def sweep(fn, cs_=cs_):
            return [fn(p, u, out=out0, alpha=-1.0, accumulate=True) for _, p, u, out0 in cs_]

        terms, rows = sum(len(p.xi) for _, p, _, _ in cs_), sum(p.rows for _, p, _, _ in cs_)
        bnd = bound(B * terms, table_bytes(*(p for _, p, _, _ in cs_)) + el * B * (terms + 2 * rows), dtype)
        log(f"  gather_segsum every {nm} level {dtype_name(dtype)} ({len(cs_)} plans, one per level, {rows} rows, "
            f"{terms} terms): worst rel={worst[nm][0]:.3e} (level {worst[nm][2]}, max_abs_err={worst[nm][1]:.3e}; "
            f"tol {tol:.0e}); the schedule kernel_ms={cuda_ms(lambda: sweep(kernels.gather_segsum), SN_REPS, 1):.3f} "
            f"plain_ms={cuda_ms(lambda: sweep(kernels.gather_segsum_plain), SN_REPS, 1):.3f} "
            f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})")
    Q = post
    per_factor = launch_count(kernels.gather_segsum, lambda: sn.supernodal_factorize(Q))
    per_solve = launch_count(kernels.gather_segsum, lambda: fk.solve(b))
    log(f"  gather_segsum launches per factorization {per_factor} (Schur plans {len(cases['schur'])} + the logdet), "
        f"per solve {per_solve} (forward plans {len(cases['fwd'])} + the permutation and its inverse); at most 15 each")
    if per_factor != len(cases["schur"]) + 1 or per_solve != len(cases["fwd"]) + 2 or max(per_factor, per_solve) > 15:
        raise AssertionError(f"gather_segsum: {per_factor} launches per factorization, {per_solve} per solve")
    # both row runs, rows in two parts, a partial group of chains and a shared y, on a plan of random rows
    lengths = np.concatenate([rng.integers(0, 40, 300), rng.integers(200, 5000, 20)])
    ptr, m = np.concatenate([[0], np.cumsum(lengths)]), int(lengths.sum())
    mixed = kernels.SegPlan(rng.integers(0, 900, m), ptr=ptr, yi=rng.integers(0, 900, m), zi=rng.integers(0, 900, m),
                            t=rng.permutation(400)[:len(lengths)], split=(lengths * rng.random(len(lengths))).astype(int))
    y_ = torch.tensor(rng.normal(size=900), dtype=dtype, device=dev)  # shared by the chains
    runs = []
    for B_ in (9, 20):  # one chain group partial, then three groups (the chunks' scratch grows)
        x_, z_, o_ = (torch.tensor(rng.normal(size=(B_, w)), dtype=dtype, device=dev) for w in (900, 900, 400))

        def run(x_=x_, z_=z_, o_=o_):
            return kernels.gather_segsum(mixed, x_, y_, o_.clone(), -0.5, True, z_)

        got = run()
        check(f"gather_segsum mixed rows (B={B_}; {mixed.r_block} rows by thread, {mixed.rows - mixed.r_block} in "
              f"{mixed.chunks} chunks, in two parts; plain in f64)", dtype, got,
              kernels.gather_segsum_plain(mixed, x_.double(), y_.double(), o_.double().clone(), -0.5, True,
                                          z_.double()), "gather_segsum", {})
        runs.append((got, run))
    if not torch.equal(runs[0][0], runs[0][1]()):  # the tickets were reset: a second launch gives the same bits
        raise AssertionError("gather_segsum mixed rows: a second launch differs from the first")
    # the one-launch sums: the logdet's 2n terms, selinv_dot's nnz products; held to the plain version in float64
    # on the same values (one sum of 10^4-10^5 terms: the plain version's float32 atomics add in no fixed order)
    logs = torch.tensor(rng.normal(size=(B, 2 * n)), dtype=dtype, device=dev)
    z = torch.tensor(rng.normal(size=(B, Q.nnz)), dtype=dtype, device=dev)
    dot = sn._sum_plan(Q.nnz, dot=True)
    for label, plan, args in (("logdet sum", dp["logdet"], (logs,)), ("selinv_dot sum", dot, (z, Q.data))):
        one = launch_count(kernels.gather_segsum, lambda: kernels.gather_segsum(plan, *args))
        check(f"gather_segsum {label} ({len(plan.xi)} terms, {one} launch; plain in f64)", dtype,
              kernels.gather_segsum(plan, *args), kernels.gather_segsum_plain(plan, *(a.double() for a in args)),
              "gather_segsum", {}, cuda_ms(lambda: kernels.gather_segsum(plan, *args)),
              cuda_ms(lambda: kernels.gather_segsum_plain(plan, *args)))
        if one != 1:
            raise AssertionError(f"gather_segsum {label}: {one} launches, want 1")


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
    (fwd, _, _), (back_a, _, _), _ = _MUL_CACHE[(A.pattern, Bm.pattern)][1]
    a, bd = A.data.contiguous(), Bm.data.contiguous()
    el, shape = a.element_size(), f"B={B} n={n}"
    check_sp_add(dtype, dev, results)
    # the library call: torch.sparse.mm of two CSR tensors, the chains as diagonal blocks
    Ab, Bb = csr_block_diag(A.data.expand(B, -1), A, dev), csr_block_diag(Bm.data.expand(B, -1), Bm, dev)
    got = kernels.gather_segsum(fwd, a, y=bd)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        lib_sum = float(torch.sparse.mm(Ab, Bb).values().double().sum())
        lib_ms = cuda_ms(lambda: torch.sparse.mm(Ab, Bb))
    check("gather_segsum sp_matmul fwd", dtype, got,
          kernels.gather_segsum_plain(fwd, a, y=bd), "gather_segsum", {},
          cuda_ms(lambda: kernels.gather_segsum(fwd, a, y=bd)),
          cuda_ms(lambda: kernels.gather_segsum_plain(fwd, a, y=bd)),
          cost=(2 * B * len(fwd.xi), table_bytes(fwd) + el * B * (a.shape[1] + bd.shape[1] + fwd.rows)),
          library_ms=lib_ms, shape=shape,
          extra=f" (library: torch.sparse.mm of two block-diagonal CSR tensors; the sum of its values "
                f"{abs(lib_sum / float(got.double().sum()) - 1):.1e} from the kernel's)")
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
    check_segsum_schedule(post, fk, dp, b, dtype, dev)
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
        ms, lib_ms = (cuda_ms(lambda: sn.supernodal_factorize(Q), SN_REPS, 1),
                      cuda_ms(lambda: plain_factorize(Q), SN_REPS, 1)) if timing else (None, None), None
        if timing:  # the library yardstick, and K6's launches per factorization
            lib = k6_library(Q, fk.meta)
            lib_ms = cuda_ms(lib, 3, 1)
            boosts += (f"; library: cholesky_ex of the densified matrix + the gather onto L's pattern, "
                       f"{rel_err((lib(),), (fk.vals[:, :-1],))[1]:.1e} from the kernel's factor; "
                       f"{launch_count(kernels.sn_panel, lambda: sn.supernodal_factorize(Q))} launches")
            del lib
        check(f"sn_panel factor vals [{label}]", dtype, fk.vals, fp.vals, "sn_panel", results, *ms, extra=boosts,
              cost=costs["sn_panel"], library_ms=lib_ms, shape=shape)
        check(f"sn_panel logdet [{label}]", dtype, fk.logdet(), fp.logdet(), "logdet", {},
              extra=f" logdet={fk.logdet().tolist()}")
        for k in (1, 8, 65) if timing else (1,):  # K7 against its plain version, at k=1, 8 and 65 right-hand sides
            bk = b if k == 1 else torch.tensor(rng.normal(size=(B, n, k)), dtype=dtype, device=dev)
            ms, lib_ms, extra = (cuda_ms(lambda: fk.solve(bk), SN_REPS, 1),
                                 cuda_ms(lambda: fkp.solve(bk), SN_REPS, 1)) if timing else (None, None), None, ""
            if timing:
                lib = k7_library(fk, bk)
                lib_ms = cuda_ms(lib, 3, 1)
                extra = (f" (library: cholesky_solve on the densified factor, {rel_err((lib(),), (fk.solve(bk),))[1]:.1e}"
                         f" from the kernels' solve; {launch_count(kernels.sn_trsv, lambda: fk.solve(bk))} launches)")
                del lib
            check(f"sn_trsv solve k={k} [{label}]", dtype, fk.solve(bk), fkp.solve(bk), "sn_trsv",
                  results if k == 1 else {}, *ms, cost=sn_costs_k(costs["sn_trsv"], k, el, B, n), extra=extra,
                  library_ms=lib_ms, shape=shape + ("" if k == 1 else f" k={k}"))
        # K8's first entry and K8, each against its plain version on the same inputs (K8 on the kernel's C
        # and A), then the whole Σ (prep + sweep) against the plain path and the library yardstick
        dp = sn._device_plan(fk.meta, dev)
        classes, width = [c for lv in dp["levels"] for c in lv.classes], fk.vals.shape[1]

        def prep(fn):
            return k8_prep(fk.vals, width, dp["prep"], fn)

        pre = prep(kernels.sn_takahashi_prep)
        ms = (cuda_ms(lambda: prep(kernels.sn_takahashi_prep), SN_REPS, 1),
              cuda_ms(lambda: prep(kernels.sn_takahashi_prep_plain), SN_REPS, 1)) if timing else (None, None)
        check(f"sn_takahashi_prep C, A [{label}]", dtype, pre, prep(kernels.sn_takahashi_prep_plain),
              "sn_takahashi_prep", results, *ms, cost=costs["sn_takahashi_prep"], shape=shape,
              extra=f" ({len(dp['prep'])} calls, one per class shape;"
                    f" {launch_count(kernels.sn_takahashi_prep, lambda: prep(kernels.sn_takahashi_prep))} launches)")

        def sweep(fn):
            return k8_sweep(pre, classes, fn)

        ms = (cuda_ms(lambda: sweep(kernels.sn_takahashi), SN_REPS, 1),
              cuda_ms(lambda: sweep(kernels.sn_takahashi_sweep_plain), SN_REPS, 1)) if timing else (None, None)
        check(f"sn_takahashi sweep [{label}]", dtype, sweep(kernels.sn_takahashi),
              sweep(kernels.sn_takahashi_sweep_plain), "sn_takahashi", results, *ms, cost=costs["sn_takahashi"],
              shape=shape, extra=f" ({len(classes)} calls;"
                                f" {launch_count(kernels.sn_takahashi, lambda: sweep(kernels.sn_takahashi))} launches)")
        extra = ""
        if timing:
            whole = bound(costs["sn_takahashi_prep"][0] + costs["sn_takahashi"][0],
                          el * B * 2 * (nnzL + 1) + table_bytes() + sum(c[k].numel() * 4 for c in classes
                                                                        for k in ("panel", "schur")), dtype)
            lib = k8_library(fk.vals, fk.meta)
            lib_err = rel_err((lib(),), (fk._sigma_vals()[:, :-1],))[1]
            extra = (f" kernel_ms={cuda_ms(fk._sigma_vals, SN_REPS, 1):.3f} plain_ms="
                     f"{cuda_ms(fkp._sigma_vals, SN_REPS, 1):.3f} library_ms={cuda_ms(lib, 3, 1):.3f} bound_ms="
                     f"{whole['bound_ms']:.4f} ({whole['bound_by']}) (the whole schedule; library: "
                     f"torch.cholesky_inverse of the densified factor + the gather onto L's pattern, "
                     f"{lib_err:.1e} from the kernels' Σ)")
        check(f"sn_takahashi sigma, prep + sweep [{label}]", dtype, fk._sigma_vals(), fkp._sigma_vals(),
              "sn_takahashi", {}, extra=extra)
    check_panel_rescue(fk, dtype, dev)
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


def verbose_iterations(fn) -> int:
    """Newton iterations of the slowest chain of fn() (a call with verbose options), from the loop's lines."""
    import contextlib
    import io

    out = io.StringIO()
    with torch.no_grad(), contextlib.redirect_stdout(out):
        fn()
    return sum(line.startswith("newton it=") for line in out.getvalue().splitlines())


def newton_iterations(model, y, z) -> int:
    """Iterations of the spatial slice's Laplace Newton loop (the slowest
    chain's) at θ = exp(z), counted from the loop's verbose lines."""
    import tpu_gmrf_torch as tg

    theta = torch.exp(z)
    opts = tg.GAOptions(max_iter=SP_GA_ITER, inner_solver=tg.SolverSpec(kind="supernodal"), verbose=True)
    return verbose_iterations(lambda: tg.laplace_marginal(model, tg.ExponentialFamily("poisson"), y,
                                                          {"tau": theta[:, 0], "range": theta[:, 1]}, options=opts))


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


def flagship_spec():
    """The flagship's ParamSpec (bench.py:445-504): τ log-normal through log, ρ flat on (−1, 1) through logit."""
    from tpu_gmrf_torch.samplers import LogitTransform, LogTransform, ParamSpec

    return ParamSpec(tau=(LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
                     rho=(LogitTransform(-1.0, 1.0), lambda r: 0.0))


def logdensity(y):
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import make_logdensity

    model, obs = tg.AR1Model(N), tg.ExponentialFamily("poisson")
    opts = tg.GAOptions(max_iter=GA_MAX_ITER)
    return make_logdensity(lambda th: tg.laplace_marginal(model, obs, y, th, options=opts), flagship_spec())


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


def check_slice(name, v, g, ref_v, ref_g, chains, tol_key, tol=SLICE_TOL, ref_name="f64 plain", dims: int = 2):
    if not (torch.isfinite(v).all() and torch.isfinite(g).all()) or v.shape != (chains,) or g.shape != (chains, dims):
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
    check_dense_rescue(dn_model, dtype, dev)
    for nx, ny in DENSE_SHAPES:
        check_dense_shape(nx, ny, dtype, dev)
    if dtype == torch.float64:
        dense_chol_trace(data, t)
    Dinv = got[4]
    b = torch.tensor(np.random.default_rng(7).normal(size=(B, n, 1)), dtype=dtype, device=dev)
    sb = s[..., None] * b
    # the Newton solve: both triangles (mode 2), one right-hand side
    check("dense_trsv solve", dtype, kernels.dense_trsv(L, s, b, 2, Dinv), kernels.dense_trsv_plain(L, s, b, 2),
          "dense_trsv", results, cuda_ms(lambda: kernels.dense_trsv(L, s, b, 2, Dinv)),
          cuda_ms(lambda: kernels.dense_trsv_plain(L, s, b, 2)),
          cost=(B * 2 * n * n, el * B * (n * (n + 1) // 2 + 3 * n)),
          library_ms=cuda_ms(lambda: torch.cholesky_solve(sb, L)), shape=f"{shape} k=1",
          extra=f" (library: torch.cholesky_solve, both triangles; solve_triangular L^-1 "
                f"{cuda_ms(lambda: torch.linalg.solve_triangular(L, sb, upper=False)):.3f} ms; "
                f"{launch_count(kernels.dense_trsv, lambda: kernels.dense_trsv(L, s, b, 2, Dinv))} launch)")
    check_trsv_modes(L, s, Dinv, shape, dtype, dev)
    try:  # on the card K10 solves by K9's tiles, and raises without them
        kernels.dense_trsv(L, s, b, 2)
    except ValueError as e:
        log(f"  dense_trsv without K9's tiles raises: {e}")
    else:
        raise AssertionError("dense_trsv: no error without K9's tiles")
    # K10's second entry: Σ on Q's pattern (DenseLogdet's backward, selinv)
    r, c = t.on(dev)["rows"], t.on(dev)["cols"]
    rl, cl = r.long(), c.long()
    terms = float((n - torch.maximum(rl, cl)).sum())  # products of the row dots: X is upper triangular
    check("dense_selinv Σ on Q's pattern", dtype, kernels.dense_selinv(L, s, r, c, Dinv),
          kernels.dense_selinv_plain(L, s, r, c), "dense_selinv", results,
          cuda_ms(lambda: kernels.dense_selinv(L, s, r, c, Dinv), 5),
          cuda_ms(lambda: kernels.dense_selinv_plain(L, s, r, c), 5),
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
    check_bt_trsv_cases(P, t, factors, rows, dtype)
    # the banded Takahashi sweep, off the NUTS path: K8's first entry on all K blocks at once (two calls: the
    # K - 1 blocks with rows below, and the last), then K8 once per block (W = M = s), each against its plain
    # version, then the whole sweep; bounds from each entry's own step counts per block (ns = s, m = s rows
    # below it, none below the last) and the factor's blocks read once plus Σ's (and C and A's) written once
    meta = (Q.pattern, None)
    classes, preps = tb.block_classes(K, sblk, dev)
    vals, width = P.reshape(B, -1), P[0].numel() + 1
    ms_ = [sblk] * (K - 1) + [0]
    prep_cost = (B * sum(2 * sblk**3 / 3 + m * sblk**2 for m in ms_),
                 el * B * 2 * (K * sblk * (sblk + 1) // 2 + (K - 1) * sblk * sblk))
    sweep_cost = (B * sum(2 * m * m * sblk + m * sblk**2 for m in ms_), prep_cost[1])
    pre = k8_prep(vals, width, preps, kernels.sn_takahashi_prep)
    halves = (("sn_takahashi_prep banded C, A", lambda f: k8_prep(vals, width, preps, f), kernels.sn_takahashi_prep,
               kernels.sn_takahashi_prep_plain, prep_cost),
              ("sn_takahashi banded sweep", lambda f: k8_sweep(pre, classes, f), kernels.sn_takahashi,
               kernels.sn_takahashi_sweep_plain, sweep_cost))
    for label, fn, kern, plain, cost in halves:
        check(label, dtype, fn(kern), fn(plain), kern.__name__, {},
              extra=f" kernel_ms={cuda_ms(lambda: fn(kern), 3, 1):.3f} plain_ms={cuda_ms(lambda: fn(plain), 3, 1):.3f}"
                    f" bound_ms={bound(*cost, dtype)['bound_ms']:.4f} ({launch_count(kern, lambda: fn(kern))} launches)")
    plain = (kernels.sn_takahashi_prep_plain, kernels.sn_takahashi_sweep_plain)
    whole = bound(prep_cost[0] + sweep_cost[0], prep_cost[1], dtype)
    library = banded_sigma_library(P)
    check("sn_takahashi banded sigma, prep + sweep", dtype, tb._sigma_vals(P, meta), tb._sigma_vals(P, meta, plain),
          "sn_takahashi", {},
          extra=f" kernel_ms={cuda_ms(lambda: tb._sigma_vals(P, meta), 3, 1):.3f} plain_ms="
                f"{cuda_ms(lambda: tb._sigma_vals(P, meta, plain), 3, 1):.3f} library_ms="
                f"{cuda_ms(library, 3, 1):.3f} (whole sweep; library: torch.cholesky_inverse of the densified "
                f"factor, then the gather onto the blocks) bound_ms={whole['bound_ms']:.4f} ({whole['bound_by']}; "
                f"{prep_cost[0] + sweep_cost[0]:.3e} flops, {prep_cost[1] / 1e6:.1f} MB)")
    del library
    return results


def banded_factor_dense(P):
    """K11's factor P (B, K, 2s, s) densified: L (B, K s, K s) with L_k (its lower triangle) on the diagonal blocks
    and M_k below them, in the factor's permuted, padded basis."""
    B, K, _, s = P.shape
    L = P.new_zeros(B, K * s, K * s)
    for k in range(K):
        o = slice(k * s, (k + 1) * s)
        L[:, o, o] = P[:, k, :s].tril()
        if k < K - 1:
            L[:, (k + 1) * s:(k + 2) * s, o] = P[:, k, s:]
    return L


def banded_sigma_library(P):
    """The banded Σ's library yardstick (`_sigma_blocks`, the function K8's two entries compute on the blocks):
    torch.cholesky_inverse of the densified factor, then the gather of Σ onto the blocks' layout (B, K, 2s, s)
    (row k s + r, column k s + c of panel k; the last panel's lower half reads the last row), as a callable; the
    densified factor and the gather's indices are built outside it."""
    B, K, s2, s = P.shape
    L = banded_factor_dense(P)
    k, r, c = (torch.arange(n, device=P.device) for n in (K, s2, s))
    rows = (k[:, None, None] * s + r[None, :, None]).clamp(max=K * s - 1).expand(K, s2, s)
    cols = (k[:, None, None] * s + c[None, None, :]).expand(K, s2, s)
    return lambda: torch.cholesky_inverse(L)[:, rows, cols]


def dense_rel(got, ref) -> float:
    """Normwise distance of K9's outputs (L, s, logdet) from the plain version's, over the entries finite in the
    plain version, whose NaN masks the kernel's must equal."""
    err = scale = 0.0
    for g, r in zip(got, ref):
        if not torch.equal(g.isnan(), r.isnan()):
            raise AssertionError("dense_chol: NaN masks of kernel and plain differ")
        fin = ~r.isnan()
        if bool(fin.any()):
            err = max(err, float((g[fin].double() - r[fin].double()).abs().max()))
            scale = max(scale, float(r[fin].double().abs().max()))
    return err / max(scale, 1e-300)


def check_dense_rescue(dn_model, dtype, dev):
    """Phase 3c: K9's ridge rescue on the card. Three g=16 posteriors whose diagonals are lowered so that the
    equilibrated matrix's smallest eigenvalue (host, float64) is -δ/2 (rescued by δ), -250δ (by 500δ) and -1000δ
    (indefinite after 500δ: a NaN factor and logdet), δ = 2e-6 n: with Q' = Q - c diag(Q) the equilibrated
    matrix is (A - c I) / (1 - c). Levels equal to the plain version's, values within its limit."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import dense as td

    n = dn_model.n
    delta = 2e-6 * n
    Q = random_posterior(dn_model, 3, torch.float64, dev, 12)
    t = td._tables(Q.pattern)
    data = Q.data.clone()
    L, _, _, _ = kernels.dense_chol_plain(data.cpu(), t)
    diag = torch.as_tensor(t._np["diag"], device=dev)
    for b, mu in enumerate((-0.5 * delta, -250.0 * delta, -1000.0 * delta)):
        lam = float(np.linalg.eigvalsh((L[b] @ L[b].mT).numpy())[0])
        c = (lam - mu) / (1.0 - mu)
        data[b, diag] *= 1.0 - c
    data = data.to(dtype).contiguous()
    got, ref = kernels.dense_chol(data, t), kernels.dense_chol_plain(data, t)
    torch.cuda.synchronize()
    levels = got[2].tolist()
    rel, tol = dense_rel((got[0], got[1], got[3]), (ref[0], ref[1], ref[3])), SN_TOL[dtype]["dense_chol"]
    log(f"  dense_chol forced rescue {dtype_name(dtype)} (B=3 n={n}: smallest eigenvalue -δ/2, -250δ, -1000δ): "
        f"levels kernel {levels} plain {ref[2].tolist()}, logdet {got[3].tolist()}, rel={rel:.3e} (tol {tol:.0e}) "
        f"over the finite entries, NaN masks equal; kernel_ms={cuda_ms(lambda: kernels.dense_chol(data, t)):.3f}")
    if levels != ref[2].tolist() or levels != [1, 2, 2] or not rel <= tol:
        raise AssertionError(f"dense_chol forced rescue: levels {levels} / {ref[2].tolist()}, rel {rel:.3e}")


def lattice_precision(nx: int, ny: int, dtype, dev):
    """One precision on an nx x ny lattice (n = nx ny, the dense backend's shapes of phases 15 and 16):
    (4 + e^z) I minus the lattice's adjacency, z ~ N(0, 1) per node (seed 13)."""
    import scipy.sparse as sp

    from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern

    def path(m):
        return sp.diags([np.ones(m - 1), np.ones(m - 1)], [-1, 1])

    adj = sp.kron(sp.identity(ny), path(nx)) + sp.kron(path(ny), sp.identity(nx))
    n = nx * ny
    Q = (sp.diags(4.0 + np.exp(np.random.default_rng(13).normal(size=n))) - adj).tocoo()
    pat = SparsePattern(Q.row, Q.col, Q.shape)
    return SparseMatrix(torch.tensor(Q.data[pat.sort_order][None], dtype=dtype, device=dev), pat)


def check_dense_shape(nx: int, ny: int, dtype, dev):
    """Phase 3c: K9 at B=1 on a lattice of n = nx ny (the shapes phases 15 and 16 give it) against its plain
    version and cholesky_ex, with times."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import dense as td

    Q = lattice_precision(nx, ny, dtype, dev)
    n, el = Q.shape[0], Q.data.element_size()
    data, t = Q.data.contiguous(), td._tables(Q.pattern)
    got, ref = kernels.dense_chol(data, t), kernels.dense_chol_plain(data, t)
    if got[2].tolist() != ref[2].tolist() or got[2].any():
        raise AssertionError(f"dense_chol n={n}: rescue levels kernel {got[2].tolist()} plain {ref[2].tolist()}")
    A = got[0] @ got[0].mT
    check(f"dense_chol B=1 n={n}", dtype, (got[0], got[1], got[3]), (ref[0], ref[1], ref[3]), "dense_chol", {},
          cuda_ms(lambda: kernels.dense_chol(data, t)), cuda_ms(lambda: kernels.dense_chol_plain(data, t)),
          cost=(n**3 / 3, table_bytes(t) + el * (Q.nnz + n * n + n + 1)),
          library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(A)), shape=f"B=1 n={n}",
          extra=" (library: torch.linalg.cholesky_ex of the equilibrated (1, n, n))")
    check_trsv_modes(got[0], got[1], got[4], f"B=1 n={n}", dtype, dev)


def check_trsv_modes(L, s, Dinv, shape: str, dtype, dev):
    """Phase 3c: K10 on K9's factor and tiles in modes 0 (L⁻¹), 1 (L⁻ᵀ) and 2 (both) at k = 1, 8 and 65
    right-hand sides (one group of 8; a group of 64 and a partial one) against its plain version, with times;
    mode 2 also beside the library call, s∘cholesky_solve(s∘b, L)."""
    from tpu_gmrf_torch import kernels

    B, n = s.shape
    el = L.element_size()
    rng = np.random.default_rng(17)
    for k in (1, 8, 65):
        b = torch.tensor(rng.normal(size=(B, n, k)), dtype=dtype, device=dev)
        sb = s[..., None] * b
        for mode in (0, 1, 2):  # cost: L's lower triangle, s and b read once, x written once
            check(f"dense_trsv mode {mode} {shape} k={k}", dtype, kernels.dense_trsv(L, s, b, mode, Dinv),
                  kernels.dense_trsv_plain(L, s, b, mode), "dense_trsv", {},
                  cuda_ms(lambda: kernels.dense_trsv(L, s, b, mode, Dinv)),
                  cuda_ms(lambda: kernels.dense_trsv_plain(L, s, b, mode)),
                  cost=(B * k * n * n * (2 if mode == 2 else 1), el * B * (n * (n + 1) // 2 + n + 2 * n * k)),
                  library_ms=cuda_ms(lambda: s[..., None] * torch.cholesky_solve(sb, L)) if mode == 2 else None)


def dense_chol_trace(data, t):
    """Phase 3c: one K9 call under torch.profiler: one kernel launch, no device-to-host copy, no stream
    synchronize (the rescue is decided on the card)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_gmrf_torch import kernels

    kernels.dense_chol(data, t)  # warm: the cluster size is queried once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernels.dense_chol(data, t)
        torch.cuda.synchronize()
    ev = prof.events()
    dev_kernels = [e.name for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    host_calls = sorted({e.name for e in ev if e.name.startswith("cuda") and e.name != "cudaDeviceSynchronize"})
    blocking = [nm for nm in host_calls + dev_kernels if "Memcpy" in nm or "StreamSynchronize" in nm]
    log(f"  dense_chol in a torch.profiler trace (B={data.shape[0]} n={t.n}): device activities {dev_kernels}, "
        f"host CUDA calls {host_calls}")
    if len(dev_kernels) != 1 or "dense_chol_kernel" not in dev_kernels[0] or blocking:
        raise AssertionError(f"dense_chol: expected one launch and no copy or synchronize, got {dev_kernels}, "
                             f"{blocking}")


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
    eps = res.step_size.double().cpu()
    steps = (f"step sizes {[round(x, 4) for x in eps.tolist()]}" if chains <= 8 else "step size quartiles "
             f"{[round(x, 4) for x in torch.quantile(eps, torch.tensor([0.25, 0.5, 0.75], dtype=eps.dtype)).tolist()]}")
    return (f"{chains * samples / secs:.4f} samples/s ({chains} chains x {samples} draws in {secs:.1f} s, warmup "
            f"included), depth per sampling transition mean {res.depth.float().mean():.2f} max "
            f"{int(res.depth.max())}, mean acceptance {res.accept_prob.mean():.3f}, divergences "
            f"{int(res.diverging.sum())}, {steps}")


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


def csr_block_diag(data, M, dev):
    """B chains' values `data` (B, nnz) on M's pattern as one block-diagonal CSR tensor."""
    from tpu_gmrf_torch.sparse.matrix import _csr

    rp, col = _csr(M.pattern, dev)
    (B, nnz), (r, c) = data.shape, M.shape
    crow = torch.cat([rp[:-1].long() + b * nnz for b in range(B)] + [torch.tensor([B * nnz], device=dev)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, torch.cat([col.long() + b * c for b in range(B)]),
                                       data.contiguous().reshape(-1), size=(B * r, B * c))


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
    n=20000 (in scan tiles)."""
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
        warps, rows = kernels.scan_launch(n)
        scan = f"a block of {32 * warps} threads a chain, {-(-n // (32 * warps * rows))} tiles of {rows} rows a thread"
        d, e, _ = kernels.tridiag_factor_plain(a, c)
        for name, kern, plain, cost, how in (  # (operations, bytes): inputs read once, outputs written once
            ("tridiag_factor", lambda: kernels.tridiag_factor(a, c), lambda: kernels.tridiag_factor_plain(a, c),
             (5 * B * n, el * B * (4 * n - 1)), scan),
            ("tridiag_solve", lambda: kernels.tridiag_solve(d, e, b), lambda: kernels.tridiag_solve_plain(d, e, b),
             (6 * B * n, el * B * (4 * n - 1)), scan),
            ("tridiag_selinv", lambda: kernels.tridiag_selinv(d, e), lambda: kernels.tridiag_selinv_plain(d, e),
             (5 * B * n, el * B * (4 * n - 2)), scan + ", the last first"),
        ):
            check(f"{name} n={n} B={B} ({how})", dtype, kern(), plain(), "tridiag", {},
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


def bsr_library_t(Bm, dev):
    """The BSR tensor of Aᵀ (the yardstick beside the transposed K14): A's blocks transposed, regrouped by block
    column."""
    t, nb, bs = Bm.plan.on(dev), Bm.plan.nb, Bm.plan.bs
    rp, bc = t["rowptr_l"], t["block_cols_l"]
    br = torch.repeat_interleave(torch.arange(nb, device=dev), rp.diff())
    order = torch.argsort(bc * nb + br)
    crow = torch.cat([rp.new_zeros(1), torch.bincount(bc, minlength=nb).cumsum(0)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_bsr_tensor(crow, br[order], Bm.blocks[order].mT.contiguous(), size=(nb * bs,) * 2)


def bsr_outer_library(plan, g, x, dev):
    """The yardstick beside K15: torch.sparse.sampled_addmm of Gᵀ X at the stored blocks' scalar pattern (a CSR
    tensor built outside the timing), and the permutation taking K15's flat output to its values; None where the
    card's PyTorch refuses it."""
    t, bs, N, n = plan.on(dev), plan.bs, plan.nb * plan.bs, plan.n
    ij = torch.arange(bs, device=dev)
    rows = (t["block_rows_l"][:, None, None] * bs + ij[None, :, None]).expand(-1, bs, bs).reshape(-1)
    cols = (t["block_cols_l"][:, None, None] * bs + ij[None, None, :]).expand(-1, bs, bs).reshape(-1)
    perm = torch.argsort(rows * N + cols)
    crow = torch.cat([rows.new_zeros(1), torch.bincount(rows, minlength=N).cumsum(0)])
    gt = torch.nn.functional.pad(g, (0, N - n)).T.contiguous()
    xp = torch.nn.functional.pad(x, (0, N - n))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            S = torch.sparse_csr_tensor(crow, cols[perm], torch.zeros(perm.numel(), dtype=x.dtype, device=dev),
                                        size=(N, N))
            run = lambda: torch.sparse.sampled_addmm(S, gt, xp, beta=0.0)  # noqa: E731
            run()
        return run, perm
    except (RuntimeError, NotImplementedError) as e:
        log(f"  sampled_addmm refused ({str(e).splitlines()[0][:100]}): K15 has no library yardstick")
        return None, perm


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
            blt = bsr_library_t(Bm, dev)  # the transposed product's yardstick (built outside the timing)
            bsrt_ms = cuda_ms(lambda: blt @ xpad)
            _, rel_t = rel_err(((blt @ xpad)[:n].T,), (kernels.bsr_spmm_plain(blocks, plan, x, True),))
        cost = (2 * nbl * bs * bs * k, el * (nbl * bs * bs + 2 * n * k) + 4 * (nbl + plan.nb + 1))
        tag = f"{shape} bs={bs} nblocks={nbl}" + (" (best_block_size)" if bs == best else "")
        check(f"bsr_spmm {tag}", dtype, kernels.bsr_spmm(blocks, plan, x), kernels.bsr_spmm_plain(blocks, plan, x),
              "bsr_spmm", keep, cuda_ms(lambda: kernels.bsr_spmm(blocks, plan, x)),
              cuda_ms(lambda: kernels.bsr_spmm_plain(blocks, plan, x)), cost=cost, library_ms=bsr_ms, shape=tag,
              extra=" (library: torch.sparse_bsr_tensor @ x)")
        check(f"bsr_spmm transposed {tag}", dtype, kernels.bsr_spmm(blocks, plan, x, True),
              kernels.bsr_spmm_plain(blocks, plan, x, True), "bsr_spmm", {},
              cuda_ms(lambda: kernels.bsr_spmm(blocks, plan, x, True)),
              cuda_ms(lambda: kernels.bsr_spmm_plain(blocks, plan, x, True)), library_ms=bsrt_ms,
              cost=(cost[0], cost[1] + 4 * nbl),  # the forward product's, and the transposition's block order
              extra=f" (library: torch.sparse_bsr_tensor of Aᵀ @ x, {rel_t:.1e} from plain)")
        del blt
        outer = kernels.bsr_outer(plan, g, x)
        lib, perm = bsr_outer_library(plan, g, x, dev)
        extra = ""
        if lib is not None:  # its values, in CSR order, against K15's
            _, rel_l = rel_err((lib().values(),), (outer.reshape(-1)[perm],))
            extra = f" (library: torch.sparse.sampled_addmm at the blocks' pattern, {rel_l:.1e} from K15)"
            if not rel_l <= SN_TOL[dtype]["bsr_outer"]:
                raise AssertionError(f"bsr_outer disagrees with sampled_addmm ({rel_l:.3e})")
        check(f"bsr_outer {tag}", dtype, outer, kernels.bsr_outer_plain(plan, g, x), "bsr_outer", keep,
              cuda_ms(lambda: kernels.bsr_outer(plan, g, x)), cuda_ms(lambda: kernels.bsr_outer_plain(plan, g, x)),
              cost=(2 * nbl * bs * bs * k, el * (nbl * bs * bs + 2 * n * k) + 8 * nbl), shape=tag,
              library_ms=cuda_ms(lib) if lib is not None else None, extra=extra)
        del lib
        if bs == best:  # the gradient of the BSR product against the plain version's autograd
            grads = []
            xs = x / kernels.bsr_spmm(blocks, plan, x).abs().max()  # sin's argument of order one
            for fn in (lambda b_, x_: bsr_spmv(b_, x_, plan), lambda b_, x_: kernels.bsr_spmm_plain(b_, plan, x_)):
                b_, x_ = blocks.clone().requires_grad_(), xs.clone().requires_grad_()
                torch.sin(fn(b_, x_)).sum().backward()
                grads.append((b_.grad, x_.grad))
            check(f"bsr_spmv gradient (blocks, x) {tag}", dtype, grads[0], grads[1], "bsr_outer", {})


def check_bsr_edges(Q, Qr, dtype, dev):
    """Phase 3d: K14 and K15 at their edges against their plain versions, held to SN_TOL, K14 forward and
    transposed, at each block size: one set of blocks per row (3 vectors, blocks (3, nblocks, bs, bs); K15 per
    chain), one vector, 9 vectors (two launch rows of vectors; K15 two chunks of vectors) and blocks that do not
    start on 16 bytes (one element into a buffer: the element copies in place of the 16-byte ones; K14 only) on Q
    (n=14058), and 8 vectors on Qr (n=5741, not a multiple of any block size, whose rows of x do not lie on 16
    bytes: K15's element loads). Each case is launched twice: the two results must be equal bit for bit."""
    from tpu_gmrf_torch import kernels

    rng = np.random.default_rng(15)
    for bs in (8, 16, 32):
        for label, Qc, R, kind in (("blocks per row", Q, 3, "per row"), ("one vector", Q, 1, ""),
                                   ("9 vectors", Q, 9, ""), ("blocks off 16 bytes", Q, SPMV_VECS, "offset"),
                                   ("ragged n", Qr, SPMV_VECS, "")):
            Bm = kernels.bsr_from_sparse(Qc, bs)
            plan, blocks, n = Bm.plan, Bm.blocks, Qc.shape[0]
            if kind == "per row":
                scale = torch.linspace(1.0, 2.0, R, dtype=dtype, device=dev)[:, None, None, None]
                blocks = (blocks[None] * scale).contiguous()
            elif kind == "offset":
                blocks = blocks.new_empty(blocks.numel() + 1)[1:].view(blocks.shape).copy_(blocks)
            x = torch.tensor(rng.normal(size=(R, n)), dtype=dtype, device=dev)
            for transpose in (False, True):
                got = kernels.bsr_spmm(blocks, plan, x, transpose)
                again = kernels.bsr_spmm(blocks, plan, x, transpose)
                same = bool(torch.equal(got, again))
                check(f"bsr_spmm {'transposed ' if transpose else ''}{label} n={n} k={R} bs={bs} "
                      f"(n mod bs = {n % bs})", dtype, got, kernels.bsr_spmm_plain(blocks, plan, x, transpose),
                      "bsr_spmm", {}, extra=f"; second launch equal bit for bit: {same}")
                if not same:
                    raise AssertionError(f"bsr_spmm {label} bs={bs}: two launches differ")
            if kind == "offset":
                continue
            g = torch.tensor(rng.normal(size=(R, n)), dtype=dtype, device=dev)
            per_chain = kind == "per row"
            got, again = (kernels.bsr_outer(plan, g, x, per_chain) for _ in range(2))
            same = bool(torch.equal(got, again))
            check(f"bsr_outer {label}{' (per chain)' if per_chain else ''} n={n} k={R} bs={bs} (n mod bs = {n % bs})",
                  dtype, got, kernels.bsr_outer_plain(plan, g, x, per_chain), "bsr_outer", {},
                  extra=f"; second launch equal bit for bit: {same}")
            if not same:
                raise AssertionError(f"bsr_outer {label} bs={bs}: two launches differ")


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
    check_bsr_edges(Q, matern_precision(sp_model, dtype, dev), dtype, dev)
    rng = np.random.default_rng(14)
    with torch.no_grad():
        # bt_sqrt on the banded factor of phase 3c's shape
        B, n, el = SP_CHAINS, sp_model.n, Q.data.element_size()
        f = tb.banded_factorize(random_posterior(sp_model, B, dtype, dev, 8))
        t = tb._TABLES[f.meta]
        z = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=dev)
        elems = t.K * t.s * (t.s + 1) // 2 + (t.K - 1) * t.s * t.s
        # the library: the densified factor times the permuted, padded rows, one matmul
        npad = t.K * t.s
        Ld = torch.zeros(B, npad, npad, dtype=dtype, device=dev)
        for k in range(t.K):
            o = slice(k * t.s, (k + 1) * t.s)
            Ld[:, o, o] = f.P[:, k, : t.s].tril()
            if k < t.K - 1:
                Ld[:, (k + 1) * t.s:(k + 2) * t.s, o] = f.P[:, k, t.s:]
        zb = z.new_zeros(B, npad, 1)
        zb[:, :n, 0] = z[:, t.on(dev)["perm_l"]]
        check(f"bt_sqrt B={B} n={n} s={t.s} K={t.K}", dtype, kernels.bt_sqrt(f.P, t, z), kernels.bt_sqrt_plain(f.P, t, z),
              "bt_sqrt", results, cuda_ms(lambda: kernels.bt_sqrt(f.P, t, z)),
              cuda_ms(lambda: kernels.bt_sqrt_plain(f.P, t, z)),
              cost=(2 * B * elems, el * B * (elems + 2 * n) + 4 * n), library_ms=cuda_ms(lambda: Ld @ zb),
              shape=f"B={B} n={n} s={t.s} K={t.K} k=1")
        del Ld
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
        # the library: the densified factor times the permuted rows, one matmul
        Lden, _, _ = dense_factor(fk.vals, fk.meta)
        zc = z[:, torch.as_tensor(np.asarray(fk.plan["perm"], np.int64), device=dev)][..., None]
        check(f"sn_multiply sqrt_matvec n={n}", dtype, w, fkp.sqrt_matvec(z), "sn_multiply", results,
              cuda_ms(lambda: fk.sqrt_matvec(z), SN_REPS, 1), cuda_ms(lambda: fkp.sqrt_matvec(z), SN_REPS, 1),
              cost=cost, library_ms=cuda_ms(lambda: Lden @ zc), shape=f"B=1 n={n}")
        del Lden
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


def check_trsv_columns(f, k: int, dev):
    """Phase 14: K7 at the shape of the RBMC draws, k right-hand sides of one chain: the backward solve that makes
    the draws (mode 1), the whole solve (modes 0 and 1) and the product with L (mode 2), each against its plain
    version on the same factor, with their times; and K7's column tile and blocks per chain by level, so how many
    times a chain's panel is read."""
    from tpu_gmrf_torch.kernels import supernodal as ks
    from tpu_gmrf_torch.solvers import supernodal as sn

    fp, n, B = with_plain_steps(f), f.n, f.vals.shape[0]
    levels = sn._device_plan(f.meta, dev)["levels"]
    z = torch.tensor(np.random.default_rng(k).normal(size=(n, k)), dtype=torch.float64, device=dev)
    el, nnzL = f.vals.element_size(), f.vals.shape[1] - 1
    costs = sn_costs(levels, B, el, 0, nnzL, n)
    tiles = [ks.trsv_launch(max(c["W"] for c in lv.classes), k, B * sum(c["panel"].shape[0] for c in lv.classes),
                            ks._sm_count(dev)) for lv in levels]
    with torch.no_grad():
        for name, key, kern, plain in (("backward_solve", "sn_trsv", f.backward_solve, fp.backward_solve),
                                       ("solve", "sn_trsv", f.solve, fp.solve),
                                       ("sqrt_matvec", "sn_multiply", f.sqrt_matvec, fp.sqrt_matvec)):
            check(f"sn_trsv {name} n={n} k={k}", torch.float64, kern(z), plain(z), key, {},
                  cuda_ms(lambda: kern(z), 3, 1), cuda_ms(lambda: plain(z), 2, 1),
                  cost=sn_costs_k(costs[key], k, el, B, n), shape=f"B={B} n={n} k={k}",
                  extra="" if name != "solve" else
                  f" (K7's column tile x blocks per chain by level: {' '.join('%dx%d' % t for t in tiles)})")


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
    check_trsv_columns(g.factor, RBMC_SAMPLES, dev)
    check_trsv_columns(gs.factor, BLOCK_RBMC_SAMPLES, dev)
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


def kl_backward_error(theta, count, x, jitter: float):
    """Per column of a bucket, ‖A x − e_N / x_N‖_∞ / (‖A‖_∞ ‖x‖_∞) in float64: A = (Θ + Θᵀ) / 2 + jitter I on
    the column's N valid (trailing) rows, x (B, cap) its values (the padding ignored); NaN for a NaN column."""
    B, cap = theta.shape[:2]
    valid = torch.arange(cap, device=theta.device) >= (cap - count.long())[:, None]
    th = theta.double()
    A = torch.where(valid[:, :, None] & valid[:, None, :], 0.5 * (th + th.mT), 0.0) \
        + jitter * torch.diag_embed(valid.double())
    x = torch.where(valid, x.double(), 0.0)
    r = (A @ x[..., None])[..., 0]
    r[:, -1] -= 1.0 / x[:, -1]
    return r.abs().amax(-1) / (A.abs().sum(-1).amax(-1) * x.abs().amax(-1))


def padded(vals, pos):
    """A bucket's values (B, cap) from L's data at entry_pos, zero on the padding."""
    return torch.where(pos >= 0, vals[pos.clamp_min(0).long()], 0.0)


def distance(got, ref) -> float:
    """max |got − ref| / max |ref| over the entries where both are finite."""
    fin = got.isfinite() & ref.isfinite()
    if not bool(fin.any()):
        return 0.0
    return float((got[fin] - ref[fin]).abs().max()) / max(float(ref[fin].abs().max()), 1e-300)


def check_kl_buckets(label, inputs, nnz: int, dtype, results=None, reps: int = 10):
    """K16 against its plain version (and the library yardstick) on every bucket of `inputs`: the warp path
    to the bit (SN_TOL), the tile and cluster paths by backward error and by distance (KL_FACTOR)."""
    from tpu_gmrf_torch import kernels

    el, tot = torch.finfo(dtype).bits // 8, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    err = warp_err = scale = 0.0
    nans = [0, 0]
    worst = {"backward": 0.0, "distance": 0.0}  # each reading over its limit, the largest
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
        err = max(err, b_err)
        nans[1] += broken_columns(k, count)
        path = kernels.kl_path(cap)
        if path == "warp":
            warp_err = max(warp_err, b_err)
            scale = max(scale, float(p[fin].abs().max()) if bool(fin.any()) else 0.0)
            reading = ""
        else:
            be = [float(kl_backward_error(theta, count, padded(o, pos), KL_JITTER).nan_to_num(0.0).max())
                  for o in (out_k, out_p)]
            lim_a = KL_FACTOR * be[1] + int(count.max()) * torch.finfo(dtype).eps
            x_l = kl_library(theta, count)()[..., 0]
            xp = padded(out_p, pos)
            d_k, d_l = distance(padded(out_k, pos), xp), distance(torch.where(pos >= 0, x_l, 0.0), xp)
            lim_b = KL_FACTOR * d_l
            reading = (f" backward error {be[0]:.3e} (plain {be[1]:.3e}, limit {lim_a:.3e}), distance from plain "
                       f"{d_k:.3e} (library's {d_l:.3e}, limit {lim_b:.3e})")
            if not (be[0] <= lim_a and d_k <= lim_b):
                raise AssertionError(f"kl_columns {label} cap={cap} ({path} path): {reading.strip()}")
            worst["backward"] = max(worst["backward"], be[0] / lim_a)
            worst["distance"] = max(worst["distance"], d_k / lim_b if lim_b > 0 else 0.0)
        N = count.double()
        flops = float((N**3 / 3 + N**2).sum())
        nbytes = el * float((N**2 + N).sum()) + 4 * (count.numel() * (cap + 1))
        ms = cuda_ms(lambda: kernels.kl_columns(theta, count, pos, KL_JITTER, out_k), reps, 2)
        pms = cuda_ms(lambda: kernels.kl_columns_plain(theta, count, pos, KL_JITTER, out_p), 2, 1)
        lms = cuda_ms(kl_library(theta, count), 3, 1)
        bnd = bound(flops, nbytes, dtype)
        log(f"    cap={cap} B={count.numel()} ({path} path): max_abs_err={b_err:.3e}{reading} "
            f"kernel_ms={ms:.4f} plain_ms={pms:.3f} library_ms={lms:.3f} bound_ms={bnd['bound_ms']:.5f} "
            f"({bnd['bound_by']}), NaN entries {int(k.isnan().sum())}")
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("flops", flops), ("bytes", nbytes)):
            tot[key] += v
    rel, tol = warp_err / max(scale, 1e-300), SN_TOL[dtype]["kl_columns"]
    bnd = bound(tot["flops"], tot["bytes"], dtype)
    log(f"  kl_columns {label} {dtype_name(dtype)}: warp path rel={rel:.3e} (tol {tol:.0e}); tile and cluster "
        f"paths: largest backward error / limit {worst['backward']:.3f}, distance / limit {worst['distance']:.3f}; "
        f"max_abs_err={err:.3e}, NaN entries {nans[0]} (kernel and plain masks equal), columns broken down "
        f"{nans[1]}; all buckets: kernel_ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.3f} "
        f"library_ms={tot['library_ms']:.3f} (two library calls per bucket) bound_ms={bnd['bound_ms']:.5f} "
        f"({bnd['bound_by']})")
    if not rel <= tol:
        raise AssertionError(f"kl_columns {label}: the warp path disagrees with its plain version ({rel:.3e})")
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
    """K17 against its plain version (the NaN masks equal; whether every value is equal bit for bit) and the
    library yardstick."""
    from tpu_gmrf_torch import kernels

    got, ref = kernels.block_inv(C, blocks), kernels.block_inv_plain(C, blocks)
    torch.cuda.synchronize()
    if not torch.equal(got.isnan(), ref.isnan()):
        raise AssertionError(f"block_inv {label}: NaN masks of kernel and plain differ")
    counts = blocks.plan(dtype)["counts"]
    el, s = torch.finfo(dtype).bits // 8, blocks.sizes.astype(float)
    flops = float((2 * s**3).sum())
    nbytes = el * 2 * float((s**2).sum()) + 4 * float(s.sum()) + (24 + el) * len(blocks)
    lib, nbuckets = block_inv_library(C, blocks)
    check(f"block_inv {label} ({len(blocks)} sets, sizes {int(s.min())}-{int(s.max())}, "
          f"{int((blocks.sizes > kernels.block_inv_smem_max(dtype)).sum())} on the global path)", dtype,
          got, ref, "block_inv", results if results is not None else {}, cuda_ms(lambda: kernels.block_inv(C, blocks), 10),
          cuda_ms(lambda: kernels.block_inv_plain(C, blocks), 2, 1), cost=(flops, nbytes), library_ms=cuda_ms(lib, 3, 1),
          shape=label, extra=f" (library: torch.linalg.inv per size bucket, {nbuckets} buckets; classes global, "
          f"shared, tile, warp {counts}; equal to plain bit for bit: {bool(torch.equal(got, ref))})")


def bit_equal(a, b) -> bool:
    """Equal NaN masks and equal values elsewhere, bit for bit."""
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan]))


def block_inv_edges(dtype, dev):
    """Phase 3e: K17 at its class edges against its plain version: one set of each size on either side of every
    edge (warp ≤ 32 < tile ≤ 96 < shared ≤ 169 in f64, 239 in f32 < global) of a symmetric indefinite C (a
    random symmetric matrix with a ±5 diagonal), the set of 33 with a zero leading diagonal entry (so partial
    pivoting interchanges rows at its first step), held to SN_TOL with equal NaN masks; then a singular set (its
    first row and column zero: a zero pivot at the first step) beside a set of 40, whose NaN mask must equal the
    plain version's. Each case is launched twice: the two results equal bit for bit."""
    from tpu_gmrf_torch import kernels

    rng = np.random.default_rng(19)
    n = 300
    G = rng.normal(size=(n, n))
    Cn = G + G.T + np.diag(np.where(np.arange(n) % 2, 5.0, -5.0))
    sizes = (1, 8, 32, 33, 95, 96, 97, 169, 170, 239, 240)
    sets = [np.sort(rng.choice(np.arange(1, n), s, replace=False)) for s in sizes]
    Cn[0, :] = Cn[:, 0] = 0.0
    Cn[sets[3][0], sets[3][0]] = 0.0
    C = torch.tensor(Cn, dtype=dtype, device=dev)
    for label, bs in (("class edges, sizes " + ", ".join(map(str, sizes)),
                       kernels.BlockSets(sets, [1.0 if i % 2 else -1.0 for i in range(len(sets))])),
                      ("a singular set beside a set of 40",
                       kernels.BlockSets([np.array([0, 5, 9, 40, 77]), sets[4][:40]], [1.0, -1.0]))):
        got, again, ref = kernels.block_inv(C, bs), kernels.block_inv(C, bs), kernels.block_inv_plain(C, bs)
        torch.cuda.synchronize()
        same, nan = bit_equal(got, again), got.isnan()
        if not (same and torch.equal(nan, ref.isnan())):
            raise AssertionError(f"block_inv {label} {dtype_name(dtype)}: two launches differ ({not same}) or the NaN "
                                 "masks of kernel and plain differ")
        check(f"block_inv {label} ({int(nan.sum())} NaN values, where the plain version has them; classes global, "
              f"shared, tile, warp {bs.plan(dtype)['counts']})", dtype, got[~nan], ref[~nan], "block_inv", {},
              extra=f"; second launch equal bit for bit: {same}; equal to plain bit for bit: {bit_equal(got, ref)}")


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


def synthetic_kl_bucket(rng, dtype, dev):
    """One K16 bucket beyond phase 3e's caps, (cap, Θ, count, entry_pos) and its nnz: cap 256, columns of 256,
    256, 200 and 129 rows, Θ the Matérn-3/2 kernel of uniform points."""
    from tpu_gmrf_torch.kl_cholesky import gram

    cap, count = 256, np.array([256, 256, 200, 129])
    pts = torch.tensor(rng.uniform(size=(len(count), cap, 2)), dtype=dtype, device=dev)
    pos = np.full((len(count), cap), -1)
    nxt = 0
    for b, N in enumerate(count):
        pos[b, cap - N:] = np.arange(nxt, nxt + N)
        nxt += N
    return (cap, gram(matern32)(pts, pts), torch.tensor(count, dtype=torch.int32, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev)), nxt


def check_gp_kernels(kp: dict, gp: dict, dev) -> dict:
    """Phase 3e: K16 on the n=10,000 buckets (ρ = 3 and 6) and one bucket on its cluster path, K17
    on the n=1000 glasso sets plus one set of 200 (global path), rectangular K4; f64 and f32."""
    from tpu_gmrf_torch import kernels

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
        bucket, nnz_s = synthetic_kl_bucket(rng, dtype, dev)
        check_kl_buckets(f"synthetic cap={bucket[0]} ({kernels.kl_path(bucket[0])} path)", [bucket], nnz_s, dtype,
                         reps=3)
        # K17: the n=1000 graphical lasso's cliques (+1) and separators (-1); then with a set of 200
        C = torch.tensor(gp["C"], dtype=dtype, device=dev)
        check_block_inv(f"n={len(gp['mu'])} glasso", C, gp["blocks"], dtype,
                        results if dtype == torch.float64 else None)
        sets = list(gp["cliques"]) + list(gp["seps"]) + [np.sort(rng.choice(len(gp["mu"]), 200, replace=False))]
        big = kernels.BlockSets(sets, [1.0] * len(gp["cliques"]) + [-1.0] * (len(gp["seps"]) + 1))
        check_block_inv(f"n={len(gp['mu'])} glasso + one set of 200", C, big, dtype)
        block_inv_edges(dtype, dev)
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


def spike_system(dn_model, dtype, dev, nt: int | None = None):
    """Phase 17's blocks: diag (Nt, ns, ns), sub (Nt-1, ns, ns) of Q_t ⊗ Q_s and b (Nt, ns); Nt = SPIKE_NT unless given."""
    from tpu_gmrf_torch import AR1Model

    nt = SPIKE_NT if nt is None else nt
    one = torch.ones((), dtype=torch.float64, device=dev)
    Qt = AR1Model(nt).precision(one, SPIKE_RHO * one).todense()
    Qs = matern_precision(dn_model, torch.float64, dev).todense()
    a, c = torch.diagonal(Qt), torch.diagonal(Qt, -1)
    diag, sub = a[:, None, None] * Qs, c[:, None, None] * Qs
    b = torch.tensor(np.random.default_rng(17).normal(size=(nt, Qs.shape[0])), device=dev)
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

    xd = x.detach()
    d32, s32, b32 = spike_system(dn_model, torch.float64, dev, SPIKE_ORACLE_NT)
    with torch.no_grad():
        x32, ld32 = _pbtridiag_chunks(d32, s32, b32, SPIKE_P)
    t0 = time.perf_counter()
    Qmap = SymmetricBlockTridiagonalMap(d32, s32)
    Qsp = block_tridiag_to_sparse(Qmap)
    asm_s = time.perf_counter() - t0
    f = tg.factorize(Qsp, tg.SolverSpec(kind="supernodal"))
    xs, lds = f.solve(b32.reshape(-1)).reshape(SPIKE_ORACLE_NT, ns), f.logdet()
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0 - asm_s
    x_err = float((x32 - xs).norm() / xs.norm())
    res = float((Qmap.matvec(x32.reshape(-1)) - b32.reshape(-1)).norm() / b32.norm())
    ld_err = abs(float(ld32) - float(lds)) / abs(float(lds))
    log(f"  at Nt={SPIKE_ORACLE_NT} (P={SPIKE_P}) against the supernodal solve of the assembled Q (n="
        f"{SPIKE_ORACLE_NT * ns}, nnz={Qsp.nnz}; assembly {asm_s:.1f} s, plan + factor + solve {oracle_s:.1f} s): x rel "
        f"{x_err:.3e} (tol {SPIKE_TOL['x']:.0e}), residual {res:.3e} (tol {SPIKE_TOL['residual']:.0e}), logdet "
        f"{float(ld32):.6f} vs {float(lds):.6f} rel {ld_err:.3e} (tol {SPIKE_TOL['logdet']:.0e})")
    if not (x_err <= SPIKE_TOL["x"] and res <= SPIKE_TOL["residual"] and ld_err <= SPIKE_TOL["logdet"]):
        raise AssertionError("the SPIKE solve disagrees with the supernodal solve of the assembled Q")
    del Qsp, f, d32, s32, b32, x32

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


# ---- phases 19-21: constrained Laplace, the areal models, the examples' golden values ----------------------


def grid_adjacency(m: int, n: int):
    """Example 08's four-neighbour grid adjacency (examples/08_factorization_reuse.py:32-43)."""
    import scipy.sparse as sp

    idx = np.arange(m * n).reshape(n, m)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    W = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(m * n, m * n))
    return W + W.T


def marginal_vg(model, y, theta: dict, opts):
    """Laplace marginal (B,) and its θ-gradient (B, k) in the model's hyperparameter order."""
    import tpu_gmrf_torch as tg

    th = {k: v.detach().clone().requires_grad_() for k, v in theta.items()}
    v = tg.laplace_marginal(model, tg.ExponentialFamily("poisson"), y, th, options=opts)
    v.sum().backward()
    return v.detach(), torch.stack([th[k].grad for k in model.hyperparameters], -1)


def on(theta: dict, dtype, device) -> dict:
    return {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in theta.items()}


def ga_iterations(model, y, theta: dict, opts) -> int:
    """Newton iterations of the slowest chain, counted from the loop's verbose lines."""
    import tpu_gmrf_torch as tg

    return verbose_iterations(lambda: tg.laplace_marginal(model, tg.ExponentialFamily("poisson"), y, theta,
                                                          options=dataclasses.replace(opts, verbose=True)))


def mode_residual(model, y, theta: dict, opts) -> float:
    """max |A x* − e| over the chains of the constrained Laplace mode."""
    import tpu_gmrf_torch as tg

    with torch.no_grad():
        prior = model(**theta)
        post = tg.gaussian_approximation(prior, tg.ExponentialFamily("poisson")(torch.as_tensor(
            y, dtype=prior.A.dtype, device=prior.A.device)), options=opts)
        return float((post.mean @ prior.A.T - prior.e).abs().max())


def hold_f64(label, got, ref, chains, tol=SLICE_TOL):
    """The float64 kernel path against the float64 plain path (value, per-chain gradient)."""
    v_rel, g_rel, per_chain = slice_errors(*got, *ref)
    log(f"  {label} f64 kernels vs f64 plain: value max rel {v_rel:.3e} (tol {tol['f64_value']:.0e}), grad max rel "
        f"{g_rel:.3e} (tol {tol['f64_grad']:.0e}){per_chain}")
    if not (got[0].shape == (chains,) and torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
            and v_rel <= tol["f64_value"] and g_rel <= tol["f64_grad"]):
        raise AssertionError(f"{label}: the float64 kernel path disagrees with the plain path")


def constrained_path(dev, card):
    """Phase 19: the constrained Laplace marginal and its τ-gradient on RW1(500) (tridiagonal, K1-K3) over 256
    chains in float32, and on RW2(500) (two constraints, auto -> dense, K9/K10) over 8 chains in float64."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels

    y = np.random.default_rng(1).poisson(1.0, size=CON_N).astype(np.float32)  # bench.py:395-396
    rw1, rw2 = tg.RW1Model(CON_N), tg.RW2Model(CON_N)
    opts = tg.GAOptions(max_iter=GA_MAX_ITER)
    th1 = {"tau": np.logspace(np.log10(0.5), np.log10(2.0), CON_CHAINS)}
    th2 = {"tau": np.logspace(np.log10(0.5), np.log10(2.0), CON_RW2_CHAINS)}
    kernels.reset_launches()
    # ---- the constrained Laplace path: RW1 f32 value+grad (first call, then timed), RW2 f64 ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v32, g32 = marginal_vg(rw1, y, on(th1, torch.float32, dev), opts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        marginal_vg(rw1, y, on(th1, torch.float32, dev), opts)
    torch.cuda.synchronize()
    vg_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    rw2_k = marginal_vg(rw2, y, on(th2, torch.float64, dev), opts)
    torch.cuda.synchronize()
    rw2_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    # ---- end of the constrained Laplace path ----
    launched(counts, CON_KERNELS, "constrained Laplace")
    iters = ga_iterations(rw1, y, on(th1, torch.float32, dev), opts)
    log(f"  RW1({CON_N}) + Poisson, {CON_CHAINS} chains, f32: value+grad first call {first_s:.3f} s, then "
        f"{vg_ms:.2f} ms per batched value+grad; Newton iterations (slowest chain) {iters}; RW2({CON_N}) f64, "
        f"{CON_RW2_CHAINS} chains: {rw2_ms:.1f} ms (one call, auto -> {tg.SolverSpec().resolve(rw2.precision(tau=1.0).pattern).kind}); "
        f"on {card}")
    t0 = time.perf_counter()
    ref = marginal_vg(rw1, y, on(th1, torch.float64, "cpu"), opts)
    plain_s = time.perf_counter() - t0
    ref32 = marginal_vg(rw1, y, on(th1, torch.float32, "cpu"), opts)
    hold_f64(f"RW1({CON_N})", marginal_vg(rw1, y, on(th1, torch.float64, dev), opts), ref, CON_CHAINS)
    k_v, k_g, _ = slice_errors(v32, g32, *ref)
    p_v, p_g, _ = slice_errors(*ref32, *ref)
    kp_v, kp_g, _ = slice_errors(v32, g32, *ref32)
    bound_v, bound_g = CON_F32_FACTOR * p_v + CON_F32_FLOOR, CON_F32_FACTOR * p_g + CON_F32_FLOOR
    log(f"  RW1({CON_N}) f32 kernels vs f64 plain: value max rel {k_v:.3e} (bound {bound_v:.3e}), grad max rel "
        f"{k_g:.3e} (bound {bound_g:.3e}); f32 plain (CPU tensors, same inputs) vs f64 plain: value {p_v:.3e}, grad "
        f"{p_g:.3e}; f32 kernels vs f32 plain: value {kp_v:.3e}, grad {kp_g:.3e}; the f64 plain path took "
        f"{plain_s:.1f} s on the host CPU")
    if not (torch.isfinite(v32).all() and torch.isfinite(g32).all() and k_v <= bound_v and k_g <= bound_g):
        raise AssertionError("RW1 constrained slice: the float32 kernel path is farther from float64 than f32 allows")
    hold_f64(f"RW2({CON_N})", rw2_k, marginal_vg(rw2, y, on(th2, torch.float64, "cpu"), opts), CON_RW2_CHAINS)
    for label, model, th in (("RW1", rw1, th1), ("RW2", rw2, th2)):
        res = mode_residual(model, y, on(th, torch.float64, dev), opts)
        log(f"  {label}({CON_N}) f64 Laplace modes: max |A x* - e| {res:.3e} (tol {CON_CONSTRAINT_TOL:.0e})")
        if not res <= CON_CONSTRAINT_TOL:
            raise AssertionError(f"{label}: the constrained mode leaves the constraint")
    return counts


def areal_y(n_side: int) -> np.ndarray:
    """Seeded counts from a smooth log-rate field on the grid's nodes (seed 8)."""
    g = np.linspace(0.0, 1.0, n_side)
    gx, gy = np.meshgrid(g, g)
    rate = np.exp(0.8 * np.sin(2 * np.pi * gx) * np.cos(np.pi * gy)).ravel()
    return np.random.default_rng(8).poisson(rate).astype(np.float64)


def ex08_profile(pool, model, z, taus, dtype, dev) -> dict:
    """Example 08's τ-profile through the pool (batch_size 10) and its anchor checks."""
    zt = torch.as_tensor(z, dtype=dtype, device=dev)
    t0 = time.perf_counter()
    lps = pool.batch_evaluate(lambda g: g.logpdf(zt), batch_size=EX08_BATCH,
                              tau=torch.as_tensor(taus, dtype=dtype, device=dev))
    lps = lps.double().cpu().numpy()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = np.array([float(model(tau=torch.as_tensor(t, dtype=dtype, device=dev)).logpdf(zt)) for t in taus[:4]])
    cold_s = time.perf_counter() - t0
    N = len(z)
    pred = (N - 1) / 2.0 * np.log(taus / taus[0]) - 0.5 * (taus - taus[0]) * EX08_Q
    resid = np.abs((lps - lps[0]) - pred)
    excess = float(np.max(resid - (EX08_LIMITS["abs"] + EX08_LIMITS["rel"] * np.abs(pred))))
    cold_rel = float(np.max(np.abs(lps[:4] - cold) / np.abs(cold)))
    return dict(lps=lps, warm_s=warm_s, cold_s=cold_s, resid=float(resid.max()), excess=excess, cold_rel=cold_rel,
                argmax=int(np.argmax(lps)))


def areal_path(dev, card):
    """Phase 20: Besag + Poisson and BYM2 at example 08's N = 10,000, and example 08's τ-profile."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels

    W = grid_adjacency(AREAL_GRID, AREAL_GRID)
    N = W.shape[0]
    t0 = time.perf_counter()
    besag = tg.BesagModel(W)
    besag_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bym2 = tg.BYM2Model(W)
    bym2_s = time.perf_counter() - t0
    kind = tg.SolverSpec().resolve(besag.precision(tau=torch.tensor(1.0, dtype=torch.float64)).pattern).kind
    kind2 = tg.SolverSpec().resolve(bym2.precision(tau=torch.tensor(1.0, dtype=torch.float64),
                                                   phi=torch.tensor(0.5, dtype=torch.float64)).pattern).kind
    log(f"  BesagModel on the {AREAL_GRID}x{AREAL_GRID} grid (N={N}): constructed in {besag_s:.2f} s (host clock, "
        f"its normalization on the card by auto -> {besag.normalization_backend}, f64), norms "
        f"[{besag._norms.min():.6f}, {besag._norms.max():.6f}]; BYM2Model (n={bym2.n}) in {bym2_s:.2f} s; on {card}")
    y = areal_y(AREAL_GRID)
    th_b = {"tau": np.linspace(0.5, 2.0, AREAL_CHAINS)}
    th_m = {"tau": np.linspace(0.5, 2.0, AREAL_CHAINS), "phi": np.linspace(0.2, 0.8, AREAL_CHAINS)}
    rng = np.random.default_rng(9)
    xb = rng.normal(size=(AREAL_CHAINS, bym2.n))
    xb[:, :N] -= xb[:, :N].mean(-1, keepdims=True)  # on the constraint: the spatial half sums to zero
    opts = tg.GAOptions(max_iter=GA_MAX_ITER)
    z = np.random.default_rng(42).normal(size=N)
    z -= z.mean()  # example 08's z: on the sum-to-zero constraint
    taus = np.linspace(0.5, 2.0, EX08_TAUS)

    def bym2_vg(theta, x):
        th = {k: v.detach().clone().requires_grad_() for k, v in theta.items()}
        lp = bym2(**th).logpdf(torch.as_tensor(x, dtype=th["tau"].dtype, device=th["tau"].device))
        lp.sum().backward()
        return lp.detach(), torch.stack([th["tau"].grad, th["phi"].grad], -1)

    pool = tg.make_workspace_pool(besag, tau=float(taus[0]))
    kernels.reset_launches()
    # ---- the areal path: Besag + Poisson value+grad, BYM2 logpdf+grad, example 08's profile (f32, f64) ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    besag_k = marginal_vg(besag, y, on(th_b, torch.float64, dev), opts)
    torch.cuda.synchronize()
    besag_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    besag_k2 = marginal_vg(besag, y, on(th_b, torch.float64, dev), opts)
    torch.cuda.synchronize()
    besag_ms2 = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bym2_k = bym2_vg(on(th_m, torch.float64, dev), xb)
    torch.cuda.synchronize()
    bym2_ms = (time.perf_counter() - t0) * 1e3
    prof = {dt: ex08_profile(pool, besag, z, taus, dt, dev) for dt in (torch.float32, torch.float64)}
    counts = kernels.launches()
    # ---- end of the areal path ----
    launched(counts, AREAL_KERNELS + BACKEND_KERNELS[kind] + BACKEND_KERNELS[kind2], "areal")
    iters = ga_iterations(besag, y, on(th_b, torch.float64, dev), opts)
    log(f"  Besag + Poisson, N={N}, {AREAL_CHAINS} chains, f64, auto -> {kind}: value+grad {besag_ms:.1f} ms first "
        f"call, {besag_ms2:.1f} ms second; Newton iterations {iters}; BYM2 (n={bym2.n}, auto -> {kind2}) logpdf + "
        f"(τ, φ) gradient {bym2_ms:.1f} ms; on {card}")
    if not bool((besag_k[0] == besag_k2[0]).all()):
        raise AssertionError("Besag: two value+grads of the same θ differ")
    t0 = time.perf_counter()
    hold_f64(f"Besag N={N}", besag_k, marginal_vg(besag, y, on(th_b, torch.float64, "cpu"), opts), AREAL_CHAINS)
    plain_s = time.perf_counter() - t0
    hold_f64(f"BYM2 n={bym2.n} logpdf", bym2_k, bym2_vg(on(th_m, torch.float64, "cpu"), xb), AREAL_CHAINS)
    log(f"  (the plain Besag value+grad on CPU tensors took {plain_s:.1f} s on the host CPU)")
    for dt, r in prof.items():
        log(f"  example 08 {dtype_name(dt)}: {EX08_TAUS} τ in batches of {EX08_BATCH} in {r['warm_s']:.3f} s, 4 fresh "
            f"model(tau=t).logpdf(z) in {r['cold_s']:.3f} s; max |Δlp − pred| {r['resid']:.4f} (limit 2.0 + 2.5e-3·|pred|, "
            f"max excess {r['excess']:.4f}), warm vs cold max rel {r['cold_rel']:.2e} (rtol {EX08_LIMITS['cold']:.0e}), "
            f"argmax τ {taus[r['argmax']]:.3f}; on {card}")
        if not (np.isfinite(r["lps"]).all() and r["excess"] <= 0 and r["cold_rel"] <= EX08_LIMITS["cold"]
                and r["argmax"] == 0):
            raise AssertionError(f"example 08 ({dtype_name(dt)}) misses its golden anchor")
    return counts


def as_dtype(A, dtype):
    from tpu_gmrf_torch.sparse import SparseMatrix

    return SparseMatrix(A.data.to(dtype), A.pattern)


def run_examples(dtype, dev) -> dict:
    """Examples 01, 02 and 05 as written, in `dtype` (their seeded inputs copied exactly)."""
    import scipy.sparse as sp

    import tpu_gmrf_torch as tg

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    def rmse(a, b):
        return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))

    cpu = lambda v: v.double().cpu().numpy()
    out = {}
    # example 01: AR1 temporal smoothing, then a Matérn field from scattered points (the same stream)
    rng = np.random.default_rng(0)
    n = 365
    prior = tg.AR1Model(n)(tau=t(2.0), rho=t(0.95))
    obs_idx = np.arange(0, n, 7)
    truth = np.sin(np.linspace(0, 6 * np.pi, n))
    y = truth[obs_idx] + 0.1 * rng.standard_normal(len(obs_idx))
    A = as_dtype(tg.from_scipy(sp.eye(n).tocsr()[obs_idx]), dtype)
    post = tg.linear_condition(prior, y, Q_eps=1.0 / 0.1**2, A=A)
    out["ex01 AR1 rmse"] = rmse(cpu(post.mean), truth)
    out["ex01 AR1 mean std"] = float(post.std().mean())
    pts = rng.uniform(0, 1, size=(80, 2))
    smodel = tg.MaternModel(pts, smoothness=1)
    x = smodel(tau=t(1.0), range=t(0.3))
    Aev = as_dtype(smodel.evaluation_matrix(), dtype)
    ys = np.cos(4 * pts[:, 0]) + 0.05 * rng.standard_normal(80)
    spost = tg.linear_condition(x, ys, Q_eps=1.0 / 0.05**2, A=Aev)
    out["ex01 Matern fit rmse"] = rmse(cpu(Aev.matvec(spost.mean)), ys)
    out["ex01 Matern mean std"] = float(spost.std().mean())
    # example 02: Matérn regression on 120 sites, out-of-sample on an 8x8 grid
    rng = np.random.default_rng(42)
    sites = rng.uniform(0, 2, size=(120, 2))
    truth2 = lambda p: np.sin(2.5 * p[:, 0]) * np.cos(1.5 * p[:, 1])
    y2 = truth2(sites) + 0.1 * rng.standard_normal(len(sites))
    model2 = tg.MaternModel(sites, smoothness=1)
    A2 = as_dtype(model2.evaluation_matrix(), dtype)
    post2 = tg.linear_condition(model2(tau=t(1.0), range=t(0.5)), y2, Q_eps=1.0 / 0.1**2, A=A2)
    gx, gy = np.meshgrid(np.linspace(0.2, 1.8, 8), np.linspace(0.2, 1.8, 8))
    newpts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    out["ex02 fit rmse"] = rmse(cpu(A2.matvec(post2.mean)), y2)
    out["ex02 oos rmse"] = rmse(cpu(as_dtype(model2.evaluation_matrix(newpts), dtype).matvec(post2.mean)),
                                truth2(newpts))
    out["ex02 mean std"] = float(post2.std().mean())
    # example 05: AR(2) by its PACFs, the first 150 values observed; the AR1(400) interior variance
    rng = np.random.default_rng(3)
    n5 = 200
    model5 = tg.ARModel(n5, order=2)
    prior5 = model5(tau=t(1.0), pacf1=t(0.9), pacf2=t(-0.5))
    x5 = cpu(prior5.sample(torch.Generator(device=dev).manual_seed(0)))
    obs = np.arange(150)
    y5 = x5[obs] + 0.05 * rng.standard_normal(len(obs))
    post5 = tg.linear_condition(prior5, y5, Q_eps=1.0 / 0.05**2, A=as_dtype(tg.from_scipy(sp.eye(n5).tocsr()[obs]),
                                                                             dtype))
    band = cpu(post5.std())
    out["ex05 band[150]"], out["ex05 band[-1]"] = float(band[150]), float(band[-1])
    out["ex05 forecast rmse (not held)"] = rmse(cpu(post5.mean)[150:160], x5[150:160])
    out["ex05 AR1 var[200]"] = float(tg.AR1Model(400)(tau=t(2.0), rho=t(0.7)).var()[200])
    return out


def examples_path(dev, card):
    """Phase 21: examples 01, 02 and 05 against their golden literals, float32 and float64."""
    from tpu_gmrf_torch import kernels

    kernels.reset_launches()
    # ---- the examples' path ----
    times, got = {}, {}
    for dt in (torch.float32, torch.float64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[dt] = run_examples(dt, dev)
        torch.cuda.synchronize()
        times[dt] = time.perf_counter() - t0
    counts = kernels.launches()
    # ---- end of the examples' path ----
    launched(counts, EXAMPLE_KERNELS, "examples")
    closed = 1 / (2 * (1 - 0.49))
    bad = []
    for dt, vals in got.items():
        log(f"  {dtype_name(dt)} examples 01, 02, 05 in {times[dt]:.2f} s on {card}:")
        for key, (gold, lim, where) in GOLDEN.items():
            ok = abs(vals[key] - gold) < lim
            bad += [] if ok else [f"{dtype_name(dt)} {key}"]
            log(f"    {key} {vals[key]:.6f}, golden {gold:.6f} ± {lim:g} ({where}): {'ok' if ok else 'MISSED'}")
        v = vals["ex05 AR1 var[200]"]
        ok = abs(v - closed) < 1e-2 * closed
        bad += [] if ok else [f"{dtype_name(dt)} AR1 variance"]
        log(f"    ex05 AR1(400) interior variance {v:.6f}, closed form 1/(τ(1-ρ²)) {closed:.6f} within 1%: "
            f"{'ok' if ok else 'MISSED'}; forecast rmse on the port's own draw {vals['ex05 forecast rmse (not held)']:.4f} "
            f"(not held: the golden 1.085257 is on the JAX package's draw)")
    if bad:
        raise AssertionError(f"golden values missed: {bad}")
    return counts


# ---- phase 22: observation breadth ---------------------------------------------


def bernoulli_marks(g: int) -> np.ndarray:
    """Marks at the g x g grid nodes: Bernoulli(sigmoid(sin 3x · cos 2y)), seed 1 (as spatial_y draws its counts)."""
    pts = grid_points(g)
    field = np.sin(3.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    return np.random.default_rng(1).binomial(1, 1.0 / (1.0 + np.exp(-field))).astype(np.float32)


def lt_obs(model, dtype, device):
    """Example 03's observation model: Bernoulli/logit through the model's evaluation matrix."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.sparse import SparseMatrix

    A = model.evaluation_matrix()
    A = SparseMatrix(A.data.to(dtype=dtype, device=device), A.pattern)
    return tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("bernoulli"), A)


def lt_logdensity(model, y, dtype, device, verbose: bool = False):
    """Phase 7's log-density over (τ, range) with example 03's observations."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import LogTransform, ParamSpec, make_logdensity

    spec = ParamSpec(
        tau=(LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
        range=(LogTransform(), lambda r: -0.5 * (torch.log(r) - np.log(0.3)) ** 2),
    )
    opts = tg.GAOptions(max_iter=SP_GA_ITER, inner_solver=tg.SolverSpec(kind="supernodal"), verbose=verbose)
    obs = lt_obs(model, dtype, device)
    return make_logdensity(lambda th: tg.laplace_marginal(model, obs, y, th, options=opts), spec)


def nc_data() -> np.ndarray:
    """y = exp(x_true) + σ ε, x_true one AR1(τ = 4, ρ = 0.9) draw of length N, seed 4."""
    rng = np.random.default_rng(NC_SEED)
    x = np.empty(N)
    x[0] = rng.normal() / np.sqrt(NC_TAU * (1 - NC_RHO**2))
    for t in range(1, N):
        x[t] = NC_RHO * x[t - 1] + rng.normal() / np.sqrt(NC_TAU)
    return (np.exp(x) + NC_SIGMA * rng.normal(size=N)).astype(np.float32)


def nc_logdensity(y, start: bool = True, verbose: bool = False):
    """The flagship's log-density over (τ, ρ) with normal observations under the log link (σ fixed); Newton
    from x0 = log(max(y, NC_X0_FLOOR)), or from laplace_marginal's start (the prior mean) with start=False."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import LogitTransform, LogTransform, ParamSpec, make_logdensity

    model, obs = tg.AR1Model(N), tg.ExponentialFamily("normal", link="log")
    spec = ParamSpec(
        tau=(LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
        rho=(LogitTransform(-1.0, 1.0), lambda r: 0.0),
    )
    opts = tg.GAOptions(max_iter=GA_MAX_ITER, verbose=verbose)

    def marginal(th):
        dt, dev = th["tau"].dtype, th["tau"].device
        if not start:
            return tg.laplace_marginal(model, obs, y, {**th, "sigma": torch.tensor(NC_SIGMA, dtype=dt, device=dev)},
                                       options=opts)
        prior = model(**th)
        yt = torch.as_tensor(y, dtype=dt, device=dev)
        lik = obs(yt, sigma=torch.tensor(NC_SIGMA, dtype=dt, device=dev))
        post = tg.gaussian_approximation(prior, lik, x0=torch.log(yt.clamp_min(NC_X0_FLOOR)), options=opts)
        return tg.marginal_loglikelihood(prior, lik, posterior=post)

    return make_logdensity(marginal, spec)


def timed_vg(ld, z):
    """(value, grad) of the first call, its seconds, and the ms of the second call (synchronized)."""
    from tpu_gmrf_torch.samplers import value_and_grad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = value_and_grad(ld, z)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    value_and_grad(ld, z)
    torch.cuda.synchronize()
    return out, first, (time.perf_counter() - t0) * 1e3


def run_example03(dtype, dev) -> dict:
    """Example 03 as written (150 sites, seed 7, τ = 0.5, range = 0.4), in `dtype`."""
    import tpu_gmrf_torch as tg

    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1, size=(150, 2))
    logit = 3.0 * np.sin(3 * pts[:, 0]) - 1.0 * pts[:, 1]
    y = (rng.uniform(size=len(pts)) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    model = tg.MaternModel(pts, smoothness=1)
    prior = model(tau=torch.tensor(0.5, dtype=dtype, device=dev), range=torch.tensor(0.4, dtype=dtype, device=dev))
    obs = lt_obs(model, dtype, dev)
    post = tg.gaussian_approximation(prior, obs(y))
    p_hat = torch.sigmoid(obs.A.matvec(post.mean))
    acc = float(((p_hat > 0.5) == (torch.as_tensor(y, device=dev) > 0.5)).double().mean())
    return {"mode norm": float(torch.linalg.vector_norm(post.mean)), "mean std": float(post.std().mean()),
            "accuracy": acc, "n": model.n, "kind": post.solver.resolve(post.Q.pattern).kind}


def observation_path(sp_model, dev, card):
    """Phase 22: example 03 at the spatial slice's size, a non-canonical link at the flagship's shape, and
    example 03 at its own size."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.inference.gaussian_approximation import _posterior_pair
    from tpu_gmrf_torch.samplers import value_and_grad

    y03 = bernoulli_marks(SP_GRID)
    sp_z = torch.tensor(np.tile([0.0, np.log(0.3)], (SP_CHAINS, 1))
                        + np.random.default_rng(5).normal(scale=0.3, size=(SP_CHAINS, 2)), dtype=torch.float32)
    ld03 = {dt: lt_logdensity(sp_model, y03, dt, dev) for dt in (torch.float32, torch.float64)}
    y_nc = nc_data()
    z_nc = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(CHAINS, 2)), dtype=torch.float32)
    ld_nc = nc_logdensity(y_nc)
    kernels.reset_launches()
    # ---- the observation-breadth path: example 03 at n=5741 (f32, f64), the log link (f32), example 03 (f32, f64) ----
    vg03, t03 = {}, {}
    for dt in (torch.float32, torch.float64):
        vg03[dt], first, ms = timed_vg(ld03[dt], sp_z.to(dtype=dt, device=dev))
        t03[dt] = (first, ms)
    spatial_counts = kernels.launches()
    vg_nc, nc_first, nc_ms = timed_vg(ld_nc, z_nc.to(dev))
    ex03 = {dt: run_example03(dt, dev) for dt in (torch.float32, torch.float64)}
    counts = kernels.launches()
    # ---- end of the observation-breadth path ----
    launched(counts, OBS_KERNELS + BACKEND_KERNELS.get(ex03[torch.float64]["kind"], ()), "observation-breadth")
    # K4's rectangular path: the launches of one likelihood gradient (η = A x, then Aᵀ g), nothing else
    obs64 = lt_obs(sp_model, torch.float64, dev)
    lik = obs64(torch.as_tensor(y03, device=dev))
    x = torch.zeros(SP_CHAINS, sp_model.n, dtype=torch.float64, device=dev)
    kernels.reset_launches()
    lik.loggrad(x)
    torch.cuda.synchronize()
    rect = kernels.launches()["csr_spmv"]
    Q = sp_model.precision(tau=torch.tensor(1.0, dtype=torch.float64, device=dev),
                           range=torch.tensor(0.3, dtype=torch.float64, device=dev))
    H = lik.loghessian(x)
    union = _posterior_pair(Q, H).pattern
    offdiag = float(H.data[:, H.pattern.rows != H.pattern.cols].abs().max()) if (H.pattern.rows != H.pattern.cols).any() else 0.0
    theta = torch.exp(sp_z.double().to(dev))
    opts_v = tg.GAOptions(max_iter=SP_GA_ITER, inner_solver=tg.SolverSpec(kind="supernodal"), verbose=True)
    iters03 = verbose_iterations(lambda: tg.laplace_marginal(sp_model, obs64, y03, {"tau": theta[:, 0], "range": theta[:, 1]},
                                                             options=opts_v))
    log(f"  (a) example 03 at n={sp_model.n}: {len(y03)} Bernoulli marks at the grid nodes through A "
        f"{obs64.A.shape[0]} x {obs64.A.shape[1]} (nnz {obs64.A.nnz}); H = Aᵀ diag(h) A on {H.pattern.nnz} entries (largest off-diagonal "
        f"|value| {offdiag:.1e}), Q_p − H on {'Q_p' if union == Q.pattern else 'a larger'}'s pattern "
        f"({union.nnz} entries); K4 launches per likelihood gradient (rectangular A x and Aᵀ g): {rect}; "
        f"launches of the f32 and f64 value+grads { {k: v for k, v in spatial_counts.items() if v} }; Newton iterations (f64, slowest chain) {iters03}")
    for dt in (torch.float32, torch.float64):
        log(f"  (a) {dtype_name(dt)} value+grad of {SP_CHAINS} chains: first call {t03[dt][0]:.3f} s, second "
            f"{t03[dt][1]:.1f} ms, on {card}")
    t0 = time.perf_counter()
    ref03 = {dt: value_and_grad(lt_logdensity(sp_model, y03, dt, "cpu"), sp_z.to(dt)) for dt in (torch.float32, torch.float64)}
    plain_s = time.perf_counter() - t0
    check_slice("ex03 f64", *vg03[torch.float64], *ref03[torch.float64], SP_CHAINS, "f64", SP_SLICE_TOL)
    k32, p32, p64 = vg03[torch.float32], ref03[torch.float32], ref03[torch.float64]
    kp_v, kp_g, kp_chain = slice_errors(*k32, *p32)
    p_v, p_g, p_chain = slice_errors(*p32, *p64)
    k_v, k_g, _ = slice_errors(*k32, *p64)
    bound_v, bound_g = EX03_F32_FACTOR * p_v + EX03_F32_FLOOR, EX03_F32_FACTOR * p_g + EX03_F32_FLOOR
    log(f"  ex03 f32 kernels vs f32 plain: value max rel {kp_v:.3e} (bound {bound_v:.3e}), grad max rel {kp_g:.3e} "
        f"(bound {bound_g:.3e}){kp_chain}; f32 plain vs f64 plain: value {p_v:.3e}, grad {p_g:.3e}{p_chain}; "
        f"f32 kernels vs f64 plain (not held): value {k_v:.3e}, grad {k_g:.3e}; the two plain paths took "
        f"{plain_s:.1f} s on the host CPU")
    if not (k32[0].shape == (SP_CHAINS,) and torch.isfinite(k32[0]).all() and torch.isfinite(k32[1]).all()
            and kp_v <= bound_v and kp_g <= bound_g):
        raise AssertionError("ex03 f32: the kernel path is farther from the f32 plain path than f32 allows")
    # (b) the log link
    iters_nc = verbose_iterations(lambda: value_and_grad(nc_logdensity(y_nc, verbose=True), z_nc.to(dev)))
    t0 = time.perf_counter()
    ref_nc = value_and_grad(ld_nc, z_nc.double())
    plain_s = time.perf_counter() - t0
    zero_v, _ = value_and_grad(nc_logdensity(y_nc, start=False), z_nc.double())
    log(f"  (b) AR1({N}) + normal/log (σ = {NC_SIGMA}), {CHAINS} chains, f32: value+grad first call {nc_first:.3f} s, "
        f"second {nc_ms:.1f} ms, Newton iterations (slowest chain) {iters_nc}, on {card}; from the prior mean "
        f"(laplace_marginal's start) the f64 plain path has {int(torch.isfinite(zero_v).sum())} of {CHAINS} chains "
        f"finite; the f64 plain path from x0 = log(max(y, {NC_X0_FLOOR})) took {plain_s:.1f} s on the host CPU")
    check_slice("log-link f64", *value_and_grad(ld_nc, z_nc.double().to(dev)), *ref_nc, CHAINS, "f64")
    check_slice("log-link f32", *vg_nc, *ref_nc, CHAINS, "f32")
    # (c) example 03 at its own size
    bad = []
    for dt, r in ex03.items():
        line = []
        for key, (gold, lim) in EX03_GOLDEN.items():
            ok = abs(r[key] - gold) <= lim
            bad += [] if ok else [f"{dtype_name(dt)} {key}"]
            line.append(f"{key} {r[key]:.6f} (golden {gold:.6f} ± {lim:.4g}: {'ok' if ok else 'MISSED'})")
        log(f"  (c) example 03, n={r['n']}, {dtype_name(dt)}, auto -> {r['kind']}: {'; '.join(line)}")
    if bad:
        raise AssertionError(f"example 03 misses its golden values: {bad}")
    return counts


# ---- phase 23: a non-Gaussian prior --------------------------------------------


def st_factor(v, log_tau):
    """A Student-t increment of the robust random walk (tests/test_nongaussian_priors.py:62-64)."""
    d = (v[1] - v[0]) * torch.exp(log_tau)
    return -0.5 * (ST_NU + 1) * torch.log1p(d**2 / ST_NU) + log_tau


def st_anchor(v, log_tau):
    return -0.5 * v[0] ** 2 / 100.0  # weak anchor for properness


def st_density(x, log_tau):
    """The whole log-density as one function of x (n,), for AutoDiffLatentPrior."""
    d = (x[1:] - x[:-1]) * torch.exp(log_tau)
    return torch.sum(-0.5 * (ST_NU + 1) * torch.log1p(d**2 / ST_NU) + log_tau) - 0.5 * torch.sum(x**2) / 100.0


def st_prior(log_tau, autodiff: bool = False):
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.sparse.matrix import _tridiag_pattern

    if autodiff:
        return tg.AutoDiffLatentPrior(theta={"log_tau": log_tau}, fn=st_density, n=N, hessian=_tridiag_pattern(N))
    idx = np.stack([np.arange(N - 1), np.arange(1, N)], axis=1)
    return tg.StructuredLatentPrior.create(N, [tg.FactorGroup(idx, st_factor), tg.FactorGroup(np.arange(N)[:, None],
                                                                                                 st_anchor)],
                                           theta={"log_tau": log_tau})


def st_vg(log_tau, y, autodiff: bool = False, verbose: bool = False):
    """(marginal (B,), d/dlog_tau (B, 1), mode (B, n)) of the robust random walk + Poisson."""
    import tpu_gmrf_torch as tg

    lt = log_tau.detach().clone().requires_grad_()
    prior = st_prior(lt, autodiff)
    lik = tg.ExponentialFamily("poisson")(torch.as_tensor(y, dtype=lt.dtype, device=lt.device))
    opts = tg.GAOptions(max_iter=GA_MAX_ITER, verbose=verbose)
    with torch.enable_grad():
        post = tg.gaussian_approximation(prior, lik, options=opts)
        v = tg.marginal_loglikelihood(prior, lik, posterior=post)
        v.sum().backward()
    return v.detach(), lt.grad[:, None], post.mean.detach()


def nongaussian_path(dev, card):
    """Phase 23: the Student-t random walk as a StructuredLatentPrior over 256 chains (f32, f64), and as an
    AutoDiffLatentPrior on the tridiagonal pattern against it (f64)."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.linear_maps import pattern_column_coloring

    y = flagship_y()
    lts = np.linspace(ST_LOG_TAU[0], ST_LOG_TAU[1], CHAINS)
    on_ = lambda dt, d=dev: torch.as_tensor(lts, dtype=dt, device=d)
    sub = np.linspace(0, CHAINS - 1, ST_AD_CHAINS).astype(int)
    t0 = time.perf_counter()
    st_prior(on_(torch.float32))
    create_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launches()
    # ---- the non-Gaussian prior path: the structured prior f32 (twice) and f64, the autodiff prior f64 ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k32 = st_vg(on_(torch.float32), y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_vg(on_(torch.float32), y)
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    k64 = st_vg(on_(torch.float64), y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ad = st_vg(on_(torch.float64)[sub], y, autodiff=True)
    torch.cuda.synchronize()
    ad_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    # ---- end of the non-Gaussian prior path ----
    launched(counts, ST_KERNELS, "non-Gaussian prior")
    from tpu_gmrf_torch.sparse.matrix import _tridiag_pattern

    ncol = pattern_column_coloring(_tridiag_pattern(N), N)[1]
    iters = verbose_iterations(lambda: st_vg(on_(torch.float32), y, verbose=True))
    post_kind = tg.SolverSpec().resolve(st_prior(on_(torch.float64)).pattern).kind
    log(f"  (a) StructuredLatentPrior (n={N}, ν={ST_NU:g}, {N - 1} + {N} factors; create {create_ms:.1f} ms on the "
        f"host) + Poisson, {CHAINS} chains, log_tau in [{ST_LOG_TAU[0]}, {ST_LOG_TAU[1]}], f32: value+grad first call "
        f"{first_s:.3f} s, second {second_ms:.1f} ms, Newton iterations (slowest chain) {iters}; auto -> {post_kind}; "
        f"on {card}")
    t0 = time.perf_counter()
    ref = st_vg(on_(torch.float64, "cpu"), y)
    plain_s = time.perf_counter() - t0
    log(f"  (the f64 plain path took {plain_s:.1f} s on the host CPU)")
    check_slice("robust RW f64", *k64[:2], *ref[:2], CHAINS, "f64", dims=1)
    check_slice("robust RW f32", *k32[:2], *ref[:2], CHAINS, "f32", dims=1)
    # (b) the autodiff prior against the structured one at the same log_tau, f64 on the card
    errs = {name: float(((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300)))
            for name, a, b in (("mode", ad[2], k64[2][sub]), ("marginal", ad[0], k64[0][sub]),
                               ("gradient", ad[1], k64[1][sub]))}
    log(f"  (b) AutoDiffLatentPrior on the tridiagonal pattern ({ncol} colours of coloured HVPs), {ST_AD_CHAINS} chains, "
        f"f64, {ad_ms:.1f} ms per value+grad, vs the StructuredLatentPrior: "
        + ", ".join(f"{k} max rel {v:.3e}" for k, v in errs.items()) + f" (tol {ST_AD_TOL:.0e}); on {card}")
    if not all(v <= ST_AD_TOL for v in errs.values()):
        raise AssertionError("the autodiff prior disagrees with the structured prior")
    return counts


# ---- phase 3g: the selected inverse's tangents K19-K22 ------------------------------------------


def f64(x):
    """A float64 copy of x (None stays None): the tangents' plain versions run in float64 on the kernels'
    inputs, as the kernels compute, so that a float32 kernel differs from them by its outputs' rounding."""
    return None if x is None else x.detach().clone().double()


def tangent_costs(ns, m, B: int, el: int, kind: str, table_bytes: int = 0) -> tuple:
    """(operations, bytes) of the tangent steps of panels of live widths ns and live row counts m (arrays) over B
    chains, triangles exploited, two operations per multiply-add. "panel" (K20) and "block" (K22's step):
    G = Ld⁻¹·Q̇_JJ·Ld⁻ᵀ (2ns³/3 multiply-adds), L̇d = Ld·F (ns³/6), L̇b = Q̇_RJ·Ld⁻ᵀ − Lb·Fᵀ (m·ns²), U̇'s
    lower triangle (m²·ns); reads L, A and Q̇, writes L̇ and (K20 only) U̇'s lower triangle. "sweep" (K21): Ȧ's
    lower triangle (5ns³/6), Ċ (m·ns²), Σ̇_RJ (2m²·ns), Σ̇_JJ's lower triangle (m·ns²); reads Ld, C, A, L̇, Σ_RJ
    and the lower triangles of Σ_RR and Σ̇_RR, writes Σ̇. Values of el bytes, plus the index tables' bytes."""
    tri, rect, sq = ns * ns / 2, m * ns, m * m / 2
    if kind == "sweep":
        fma = 5 * ns**3 / 6 + 2 * m * ns**2 + 2 * m**2 * ns
        vals = 4 * tri + 4 * rect + 2 * sq
    else:
        fma = 5 * ns**3 / 6 + m * ns**2 + m**2 * ns
        vals = 4 * tri + 3 * rect + (sq if kind == "panel" else 0)
    return 2 * B * float(np.sum(fma)), el * B * float(np.sum(vals)) + table_bytes


def written(x, c):
    """The values of x (B, width) at class batch c's live panel positions, as a new tensor."""
    pos = c["panel"].reshape(-1)
    return x[:, pos[pos != c["dummy"]].long()]


def tangent_direction(Q, seed: int):
    """A random direction on Q's pattern, (B, nnz), symmetric in its stored pairs."""
    from tpu_gmrf_torch.solvers.base import symmetric_weights

    rng = np.random.default_rng(seed)
    t = torch.tensor(rng.normal(size=Q.data.shape), dtype=Q.dtype, device=Q.device)
    t = 0.5 * (t + t[:, torch.as_tensor(Q.pattern.transpose_perm, device=Q.device)])
    return t, t * symmetric_weights(Q.pattern, Q.device, Q.dtype)


def dense_sigma_tangent(Q, t):
    """−P(Σ·T·Σ) at Q's pattern from a dense inverse (the library's way): T from t on Q's pattern."""
    B, n = Q.data.shape[0], Q.shape[0]
    A, T = Q.todense().double(), Q.with_data(t).todense().double()
    Sig = torch.cholesky_inverse(torch.linalg.cholesky(0.5 * (A + A.mT)))
    M = Sig @ T @ Sig
    r, c = (torch.as_tensor(np.asarray(a, np.int64), device=Q.device) for a in (Q.pattern.rows, Q.pattern.cols))
    return -M[:, r, c]


def check_tridiag_tangent(dtype, dev, results):
    """K19 at the flagship's shape (B=256, n=500) against its plain version (in the chains' type: K19 replays
    its recurrences in it, as K3 does), and the library's Σ̇: Σ by
    torch.cholesky_inverse of the bidiagonal factor, densified, then Σ·S·Σ by two products."""
    from tpu_gmrf_torch import kernels

    rng = np.random.default_rng(19)
    a, c = (torch.tensor(v, dtype=dtype, device=dev) for v in spd_rows(rng, CHAINS, N))
    d, e, _ = kernels.tridiag_factor(a, c)
    z, _ = kernels.tridiag_selinv(d, e)
    da = torch.tensor(rng.normal(size=(CHAINS, N)), dtype=dtype, device=dev)
    dc = torch.tensor(rng.normal(size=(CHAINS, N - 1)), dtype=dtype, device=dev)
    args = (d, e, z, da, dc)
    L = torch.diag_embed(d) + torch.diag_embed(e, -1)
    S = torch.diag_embed(da) + torch.diag_embed(dc, -1) + torch.diag_embed(dc, 1)

    def library():
        Sig = torch.cholesky_inverse(L)
        return Sig @ S @ Sig

    full = library()
    lib_err = rel_err((-torch.diagonal(full, dim1=-2, dim2=-1),), (kernels.tridiag_selinv_tangent(*args)[0],))[1]
    el = d.element_size()
    check("tridiag_selinv_tangent", dtype, kernels.tridiag_selinv_tangent(*args),
          kernels.tridiag_selinv_tangent_plain(*args), "tridiag_selinv_tangent", results,
          cuda_ms(lambda: kernels.tridiag_selinv_tangent(*args)),
          cuda_ms(lambda: kernels.tridiag_selinv_tangent_plain(*args)),
          cost=(40 * CHAINS * N, 7 * CHAINS * N * el), library_ms=cuda_ms(library, 3, 1),
          shape=f"B={CHAINS} n={N}", extra=f" (the library's Σ̇ diagonal {lib_err:.1e} from the kernel's)")


def check_tridiag_tangent_edges(dtype, dev):
    """K19 at its scan's edges: n = 1 to 20,000 (one row; a warp; the block's segments; several tiles), B = 3."""
    from tpu_gmrf_torch import kernels

    worst = 0.0
    for n in (1, 2, 33, 129, 2049, 8193, 20000):
        rng = np.random.default_rng(n)
        a, c = (torch.tensor(v, dtype=dtype, device=dev) for v in spd_rows(rng, 3, n))
        d, e, _ = kernels.tridiag_factor(a, c)
        z, _ = kernels.tridiag_selinv(d, e)
        args = (d, e, z, torch.tensor(rng.normal(size=(3, n)), dtype=dtype, device=dev),
                torch.tensor(rng.normal(size=(3, n - 1)), dtype=dtype, device=dev))
        got, ref = kernels.tridiag_selinv_tangent(*args), kernels.tridiag_selinv_tangent_plain(*args)
        pick = slice(0, 1) if n == 1 else slice(None)  # one row has no off-diagonal
        worst = max(worst, rel_err(got[pick], ref[pick])[1])
    tol = SN_TOL[dtype]["tridiag_selinv_tangent"]
    log(f"  tridiag_selinv_tangent {dtype_name(dtype)} at n = 1, 2, 33, 129, 2049, 8193, 20000 (B=3): max rel "
        f"{worst:.3e} (tol {tol:.0e})")
    if not worst <= tol:
        raise AssertionError("K19 disagrees with its plain version at its scan's edges")


def check_sn_tangents(sp_model, dtype, dev, results):
    """K20 and K21 over the whole supernodal schedule at n=5741, B=4: every class batch's launch against its
    plain version on copies of the same inputs (each held on the positions it writes), the pass continuing on
    the kernel's outputs, the times summed over the launches; then the whole Σ̇ at Q's pattern against a dense
    inverse (float64)."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import supernodal as sn

    B = SP_CHAINS
    Q = random_posterior(sp_model, B, dtype, dev, seed=20)
    f = tg.factorize(Q, tg.SolverSpec(kind="supernodal"))
    meta, vals, el = f.meta, f.vals, Q.data.element_size()
    dp = sn._device_plan(meta, dev)
    pre, sig = sn._sigma_prep(vals, meta, sn._KERNEL_OPS)
    t, tw = tangent_direction(Q, 21)
    dvals = kernels.gather_segsum(sn._scatter_plan(meta, Q.pattern), tw.contiguous(), y=f.s, z=f.s)
    vals64, pre64, sig64 = f64(vals), f64(pre), f64(sig)
    classes = [c for lv in dp["levels"] for c in lv.classes]
    shapes = [np.concatenate(a) for a in zip(*map(live_shape, classes))]
    got20, ref20, got21, ref21, ms, pms = [], [], [], [], [0.0] * 2, [0.0] * 2
    for lv in dp["levels"]:
        du = sn._buffer(vals, B, lv.zu)
        for c in lv.classes:
            dv_p, du_p = f64(dvals), f64(du)
            ms[0] += cuda_ms(lambda: kernels.sn_panel_tangent(vals, pre, dvals, c, du), 1, 0)
            pms[0] += cuda_ms(lambda: kernels.sn_panel_tangent_plain(vals64, pre64, dv_p, c, du_p), 1, 0)
            got20.append(written(dvals, c))
            ref20.append(written(dv_p, c))
            if du is not None:
                u = slice(c["ubase"], c["ubase"] + c["panel"].shape[0] * c["M"] ** 2)  # this batch's U̇
                got20.append(du[:, u].clone())
                ref20.append(du_p[:, u])
        for ell in lv.schur:
            kernels.gather_segsum(ell, du, out=dvals, alpha=-1.0, accumulate=True)
    dsig, dvals64 = torch.zeros_like(vals), f64(dvals)
    for lv in reversed(dp["levels"]):
        for c in lv.classes:
            ds_p = f64(dsig)
            ms[1] += cuda_ms(lambda: kernels.sn_takahashi_tangent(vals, pre, dvals, sig, dsig, c), 1, 0)
            pms[1] += cuda_ms(lambda: kernels.sn_takahashi_tangent_plain(vals64, pre64, dvals64, sig64, ds_p, c),
                              1, 0)
            got21.append(written(dsig, c))
            ref21.append(written(ds_p, c))
    got = sn._selinv_data(vals, f.s, Q.pattern, meta, sn._KERNEL_OPS, sig=dsig)
    ref = dense_sigma_tangent(Q, t)
    dense_err = rel_err((got,), (ref,))[1]
    L, hi, lo = dense_factor(vals, meta)
    T = Q.with_data(t).todense()
    ip = torch.as_tensor(np.asarray(sn._PLAN_CACHE[meta]["inv_perm"], np.int64), device=dev)
    Tp = torch.zeros_like(T)
    Tp[:, ip[:, None], ip[None, :]] = T * f.s[:, :, None] * f.s[:, None, :]

    def library():
        Sig = torch.cholesky_inverse(L)
        return (Sig @ Tp @ Sig)[:, hi, lo]

    lib_ms = cuda_ms(library, 2, 1)
    del L
    A, _, _ = equilibrated_dense(Q, meta)
    # K20's: L̇ of the densified, permuted, equilibrated matrix along the same (scaled, permuted) tangent
    lib20_ms = cuda_ms(lambda: torch.func.jvp(torch.linalg.cholesky, (A,), (Tp,))[1][:, hi, lo], 2, 1)
    del A
    tabs = {k: sum(c[k].numel() * 4 for c in classes) for k in ("panel", "schur")}
    shape = f"B={B} n={sp_model.n}, {len(classes)} class batches"
    check("sn_panel_tangent", dtype, got20, ref20, "sn_panel_tangent", results, ms[0], pms[0],
          f" (whole pass; Σ̇ at Q's pattern {dense_err:.1e} from a dense inverse's; library: torch.func.jvp through "
          f"torch.linalg.cholesky of the densified, permuted, equilibrated matrix)",
          tangent_costs(*shapes, B, el, "panel", tabs["panel"]), lib20_ms, shape=shape, op_dtype=torch.float64)
    check("sn_takahashi_tangent", dtype, got21, ref21, "sn_takahashi_tangent", results, ms[1], pms[1],
          " (library: torch.cholesky_inverse of the densified factor, then Σ·T·Σ by two products)",
          tangent_costs(*shapes, B, el, "sweep", tabs["panel"] + tabs["schur"]), lib_ms, shape,
          op_dtype=torch.float64)
    if dtype == torch.float64 and not dense_err <= SN_TOL[dtype]["sigma_tangent"]:
        raise AssertionError(f"the supernodal Σ̇ is {dense_err:.3e} from a dense inverse's")
    return dense_err


def check_bt_tangents(sp_model, dtype, dev, results):
    """K22 and K21 on the banded backend at n=5741, B=4 (phase 11's configuration): K22's one launch against
    its plain version on copies of its inputs, then K21 block by block as in `check_sn_tangents`. The bounds
    count the live rows: K-1 blocks have a block below, and the last block holds n − (K−1)·s of its s rows."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as bd

    B = SP_CHAINS
    Q = random_posterior(sp_model, B, dtype, dev, seed=22)
    f = tg.factorize(Q, tg.SolverSpec(kind="banded"))
    meta, P, el = f.meta, f.P, Q.data.element_size()
    _, K, s2, s = P.shape
    classes, _ = bd.block_classes(K, s, dev)
    pre, sig = bd.block_sigma(P)
    t, tw = tangent_direction(Q, 23)
    dvals = kernels.gather_segsum(bd._scatter_plan(meta, Q.pattern), tw.contiguous())
    dv_p = f64(dvals)
    view = lambda x: x[:, :-1].view(B, K, s2, s)  # noqa: E731
    ms22 = cuda_ms(lambda: kernels.bt_factor_tangent(P, view(pre), view(dvals)), 1, 0)
    P64, pre64, sig64 = f64(P), f64(pre), f64(sig)
    pms22 = cuda_ms(lambda: kernels.bt_factor_tangent_plain(P64, view(pre64), view(dv_p)), 1, 0)
    vals, vals64, dvals64 = P.reshape(B, -1), P64.reshape(B, -1), f64(dvals)
    # the library's Σ̇ = −Σ·T·Σ of the pass K22 opens: cholesky_inverse of the densified factor, two products with
    # the densified tangent, both in the factor's permuted, padded basis
    npad, dv = K * s, view(dvals)
    Ld = torch.zeros(B, npad, npad, dtype=dtype, device=dev)
    Td = torch.zeros_like(Ld)
    for k in range(K):
        o = slice(k * s, (k + 1) * s)
        Ld[:, o, o] = P[:, k, :s].tril()
        Td[:, o, o] = dv[:, k, :s].tril() + dv[:, k, :s].tril(-1).mT
        if k < K - 1:
            o2 = slice((k + 1) * s, (k + 2) * s)
            Ld[:, o2, o], Td[:, o2, o], Td[:, o, o2] = P[:, k, s:], dv[:, k, s:], dv[:, k, s:].mT

    def library():
        Sig = torch.cholesky_inverse(Ld)
        return Sig @ Td @ Sig

    lib22_ms = cuda_ms(library, 2, 1)
    del Ld, Td
    dsig = torch.zeros_like(pre)
    got21, ref21, ms21, pms21 = [], [], 0.0, 0.0
    for c in reversed(classes):
        ds_p = f64(dsig)
        ms21 += cuda_ms(lambda: kernels.sn_takahashi_tangent(vals, pre, dvals, sig, dsig, c), 1, 0)
        pms21 += cuda_ms(lambda: kernels.sn_takahashi_tangent_plain(vals64, pre64, dvals64, sig64, ds_p, c), 1, 0)
        got21.append(written(dsig, c))
        ref21.append(written(ds_p, c))
    got = bd._selinv_data(P, meta, Q.pattern, sig=dsig)
    dense_err = rel_err((got,), (dense_sigma_tangent(Q, t),))[1]
    r = sp_model.n - (K - 1) * s  # the last block's live rows
    ns = np.array([s] * (K - 1) + [r], float)
    m = np.array([s] * (K - 2) + [r, 0], float)
    tabs = sum((c["panel"].numel() + c["schur"].numel()) * 4 for c in classes)
    shape = f"B={B} n={sp_model.n} K={K} s={s}"
    check("bt_factor_tangent", dtype, (dvals,), (dv_p,), "bt_factor_tangent", results, ms22, pms22,
          f" (Σ̇ at Q's pattern {dense_err:.1e} from a dense inverse's; library: the pass's Σ̇ by cholesky_inverse of "
          f"the densified factor and two products)", tangent_costs(ns, m, B, el, "block"), lib22_ms,
          shape=shape, op_dtype=torch.float64)
    check("sn_takahashi_tangent banded", dtype, got21, ref21, "sn_takahashi_tangent_banded", {}, ms21, pms21,
          "", tangent_costs(ns, m, B, el, "sweep", tabs), shape=shape, op_dtype=torch.float64)
    if dtype == torch.float64 and not dense_err <= SN_TOL[dtype]["sigma_tangent"]:
        raise AssertionError(f"the banded Σ̇ is {dense_err:.3e} from a dense inverse's")
    return dense_err


def check_tangent_kernels(sp_model, dev) -> dict:
    """Phase 3g: K19-K22 against their plain versions, in float64 and float32."""
    results = {}
    for dtype in (torch.float32, torch.float64):
        out = results if dtype == torch.float64 else {}
        check_tridiag_tangent(dtype, dev, out)
        check_tridiag_tangent_edges(dtype, dev)
        check_sn_tangents(sp_model, dtype, dev, out)
        check_bt_tangents(sp_model, dtype, dev, out)
    return results


# ---- phase 3h: the factorizations' adjoints K23-K25 and the transpose modes --------------------------------


def chol_library(A, Lbar):
    """The library's Q̄ from L̄: torch.autograd.grad through torch.linalg.cholesky of the densified matrix A,
    fed the densified L̄; the factor's graph built once, the backward timed (one call)."""
    Ar = A.detach().clone().requires_grad_()
    L = torch.linalg.cholesky(Ar)

    def run():
        return torch.autograd.grad(L, Ar, Lbar, retain_graph=True)[0]

    return run


def check_tridiag_adjoint(dtype, dev, results):
    """K23 at the flagship's shape (B=256, n=500) against its plain version run in float64 on the kernel's
    inputs, and the library's (autograd through cholesky of the densified tridiagonal matrices)."""
    from tpu_gmrf_torch import kernels

    rng = np.random.default_rng(23)
    a, c = (torch.tensor(v, dtype=dtype, device=dev) for v in spd_rows(rng, CHAINS, N))
    d, e, _ = kernels.tridiag_factor(a, c)
    gd = torch.tensor(rng.normal(size=(CHAINS, N)), dtype=dtype, device=dev)
    ge = torch.tensor(rng.normal(size=(CHAINS, N - 1)), dtype=dtype, device=dev)
    args = (d, e, gd, ge)
    args64 = tuple(f64(x) for x in args)
    A = torch.diag_embed(a) + torch.diag_embed(c, -1) + torch.diag_embed(c, 1)
    library = chol_library(A.double(), (torch.diag_embed(gd) + torch.diag_embed(ge, -1)).double())
    el = d.element_size()
    check("tridiag_factor_adjoint", dtype, kernels.tridiag_factor_adjoint(*args),
          kernels.tridiag_factor_adjoint_plain(*args64), "tridiag_factor_adjoint", results,
          cuda_ms(lambda: kernels.tridiag_factor_adjoint(*args)),
          cuda_ms(lambda: kernels.tridiag_factor_adjoint_plain(*args)),
          cost=(16 * CHAINS * N, 6 * CHAINS * N * el), library_ms=cuda_ms(library, 3, 1), shape=f"B={CHAINS} n={N}",
          extra=" (library: autograd through cholesky of the densified matrices, f64)")


def adjoint_lbar(f, k: int, seed: int):
    """Random U, V (B, n, k) of an L̄ = P_L(U Vᵀ), in the factor's dtype and device."""
    rng = np.random.default_rng(seed)
    B, n = f.data.shape[0], f.n
    return [torch.tensor(rng.normal(size=(B, n, k)), dtype=f.data.dtype, device=f.data.device) for _ in range(2)]


def check_bt_adjoint(sp_model, dtype, dev, results):
    """K24 at n=5741, B=4, K=12, s=512 (phase 11's banded configuration): its one launch against its plain version
    in float64 on copies of its inputs (the L̄ of k=16 draws, `BandedFactor._factor_adjoint`'s), the library's Q̄
    (autograd through cholesky of the densified, permuted, padded matrix, fed the densified L̄); and bt_sqrt's
    transpose mode at k=16, 1 and 40 against its plain version and the library's product with the densified factor."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as bd

    B = SP_CHAINS
    Q = random_posterior(sp_model, B, dtype, dev, seed=24)
    f = tg.factorize(Q, tg.SolverSpec(kind="banded"))
    P = f.P
    _, K, s2, s = P.shape
    U, V = adjoint_lbar(f, 16, 25)
    view = lambda x: x[:, :-1].view(B, K, s2, s)  # noqa: E731  (the solver's buffers: one value wider)
    G = view(f._lbar(U, V))
    pre = view(bd.block_prep(P))
    got = view(P.new_zeros(B, K * s2 * s + 1))
    ms = cuda_ms(lambda: kernels.bt_factor_adjoint(P, pre, got.copy_(G)), 3, 1)
    P64, pre64 = f64(P), f64(pre)
    ref = kernels.bt_factor_adjoint_plain(P64, pre64, f64(G))
    pms = cuda_ms(lambda: kernels.bt_factor_adjoint_plain(P64, pre64, f64(G)), 1, 0)
    npad = K * s
    Ad = torch.zeros(B, npad, npad, dtype=torch.float64, device=dev)
    Lb = torch.zeros_like(Ad)
    for k in range(K):
        o = slice(k * s, (k + 1) * s)
        Lk = P64[:, k, :s].tril()
        Ad[:, o, o] = Lk @ Lk.mT + (P64[:, k - 1, s:] @ P64[:, k - 1, s:].mT if k else 0.0)
        Lb[:, o, o] = f64(G)[:, k, :s].tril()
        if k < K - 1:
            o2 = slice((k + 1) * s, (k + 2) * s)
            Ad[:, o2, o] = P64[:, k, s:] @ Lk.mT
            Ad[:, o, o2] = Ad[:, o2, o].mT
            Lb[:, o2, o] = f64(G)[:, k, s:]
    library = chol_library(Ad, Lb)
    r = sp_model.n - (K - 1) * s
    ns = np.array([s] * (K - 1) + [r], float)
    m = np.array([s] * (K - 2) + [r, 0], float)
    shape = f"B={B} n={sp_model.n} K={K} s={s}"
    check("bt_factor_adjoint", dtype, (got,), (ref,), "bt_factor_adjoint", results, ms, pms,
          " (library: autograd through cholesky of the densified, permuted, padded matrix, f64)",
          tangent_costs(ns, m, B, Q.data.element_size(), "panel"), cuda_ms(library, 2, 1), shape,
          op_dtype=torch.float64)
    del Ad, Lb, library
    t = bd._TABLES[f.meta]
    Ld = banded_factor_dense(P)
    perm = t.on(dev)["perm_l"]
    el, n = Q.data.element_size(), sp_model.n
    tri = B * (K * s * (s + 1) / 2 + (K - 1) * s * s)
    more = np.random.default_rng(33).normal(size=(B, n, max(TRANSPOSE_KS) - U.shape[-1]))
    Z = torch.cat([U, torch.tensor(more, dtype=dtype, device=dev)], -1)
    for k in TRANSPOSE_KS:
        rows = Z[..., :k].transpose(1, 2).reshape(B * k, -1).contiguous()
        zb = Z.new_zeros(B, npad, k)
        zb[:, :n] = Z[:, perm, :k]
        run = lambda: kernels.bt_sqrt_t(P, t, rows, k)  # noqa: E731
        yt = transpose_launches(run, kernels.bt_sqrt_t, f"bt_sqrt transpose k={k}")
        check(f"bt_sqrt transpose k={k}", dtype, (yt,), (kernels.bt_sqrt_t_plain(P64, t, f64(rows), k),), "bt_sqrt_t",
              results if k == 16 else {}, cuda_ms(run), cuda_ms(lambda: kernels.bt_sqrt_t_plain(P, t, rows, k)),
              f" device_ms={kernel_device_ms(lambda: [run() for _ in range(REPS)], ('bt_sqrt_t',), REPS):.4f} a "
              f"launch (library: the densified factor's transpose times the permuted rows, one matmul)",
              (2 * tri * k, el * (tri + 2 * B * k * n)), cuda_ms(lambda: Ld.mT @ zb), shape + f" k={k}")
    return f


def check_sn_adjoint(sp_model, dtype, dev, results):
    """K25 over the whole supernodal schedule at n=5741, B=4, levels descending: every class batch's launch against
    its plain version in float64 on copies of the same inputs (each held on the positions it writes), the pass
    continuing on the kernel's outputs, the times summed over the launches; the library's Q̄ (autograd through
    cholesky of the densified, permuted, equilibrated matrix, fed the densified L̄); and K7's transpose mode at
    k=16 over the schedule against its plain version and the library's product with the densified factor."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import supernodal as sn

    B = SP_CHAINS
    Q = random_posterior(sp_model, B, dtype, dev, seed=26)
    f = tg.factorize(Q, tg.SolverSpec(kind="supernodal"))
    meta, vals, el = f.meta, f.vals, Q.data.element_size()
    dp = sn._device_plan(meta, dev)
    pre = sn._prep_vals(vals, meta, sn._KERNEL_OPS)
    U, V = adjoint_lbar(f, 16, 27)
    perm = torch.as_tensor(np.asarray(sn._PLAN_CACHE[meta]["perm"], np.int64), device=dev)
    Up = torch.cat([(U / f.s[..., None])[:, perm], U.new_zeros(B, 1, 16)], 1)
    Vp = torch.cat([V, V.new_zeros(B, 1, 16)], 1)
    r, c = f._fill_rows_cols(dev)
    g = (Up[:, r] * Vp[:, c]).sum(-1)
    g0 = g.clone()
    vals64, pre64 = f64(vals), f64(pre)
    classes = [cl for lv in dp["levels"] for cl in lv.classes]
    shapes = [np.concatenate(a) for a in zip(*map(live_shape, classes))]
    got, ref, ms, pms = [], [], 0.0, 0.0
    for lv in reversed(dp["levels"]):
        for cl in lv.classes:
            gp = f64(g)
            ms += cuda_ms(lambda: kernels.sn_panel_adjoint(vals, pre, g, cl), 1, 0)
            pms += cuda_ms(lambda: kernels.sn_panel_adjoint_plain(vals64, pre64, gp, cl), 1, 0)
            got.append(written(g, cl))
            ref.append(written(gp, cl))
    L, hi, lo = dense_factor(vals, meta)
    L64 = L.double()
    Lbar = torch.zeros_like(L64)
    Lbar[:, hi, lo] = f64(g0)[:, :-1]
    library = chol_library(L64 @ L64.mT, Lbar)
    tabs = sum((cl["panel"].numel() + cl["schur"].numel()) * 4 for cl in classes)
    shape = f"B={B} n={sp_model.n}, {len(classes)} class batches"
    check("sn_panel_adjoint", dtype, got, ref, "sn_panel_adjoint", results, ms, pms,
          " (library: autograd through cholesky of the densified, permuted, equilibrated matrix, f64)",
          tangent_costs(*shapes, B, el, "panel", tabs), cuda_ms(library, 2, 1), shape, op_dtype=torch.float64)
    del Lbar, library
    check_sn_transpose(f, dtype, results, shape)
    return f


def check_bt_sqrt_t_wide(dtype, dev, s=BT_WIDE_S, K=2, B=1, k=16):
    """bt_sqrt_t on blocks wider than any phase's banded plan (s = BT_WIDE_S, where a unit's slab spans s / 2 rows):
    a random P (B, K, 2s, s) under a random permutation, the last block cut short, against its plain version in
    float64 on the same inputs, one launch a product, twice equal bit for bit."""
    from tpu_gmrf_torch import kernels

    n = K * s - 37
    rng = np.random.default_rng(34)
    plan = dict(n=n, s=s, K=K, npad=K * s, d_idx=(np.zeros(0, np.int64),) * 4, e_idx=(np.zeros(0, np.int64),) * 4,
                pad_diag=np.zeros(0, np.int64), perm=rng.permutation(n))
    t = kernels.BandedTables(plan)
    P = torch.tensor(rng.normal(size=(B, K, 2 * s, s)) / np.sqrt(s), dtype=dtype, device=dev)
    rows = torch.tensor(rng.normal(size=(B * k, n)), dtype=dtype, device=dev)
    got = transpose_launches(lambda: kernels.bt_sqrt_t(P, t, rows, k), kernels.bt_sqrt_t, f"bt_sqrt_t s={s}")
    check(f"bt_sqrt transpose wide blocks B={B} K={K} s={s} k={k}", dtype, (got,),
          (kernels.bt_sqrt_t_plain(f64(P), t, f64(rows), k),), "bt_sqrt_t", {})


def transpose_launches(run, wrapper, label):
    """run() twice: the result of its first call, required equal to the second's bit for bit, with one launch
    counted by `wrapper` per call."""
    before = wrapper.launches
    got = run()
    counted = wrapper.launches - before
    again = run()
    torch.cuda.synchronize()
    if counted != 1:
        raise AssertionError(f"{label}: {counted} launches of {wrapper.__name__} counted per call, not one")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    return got


def check_sn_transpose(f, dtype, results, shape):
    """K7's mode 3 on factor f at k = 16, 1 and 40: one launch over the whole schedule, against its plain version in
    float64 over the same table, twice equal bit for bit, its device time from a trace, the library's product
    with the densified factor; and an Lᵀz through the factor (`_tri`) counted as one K7 launch."""
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import supernodal as sn
    from tpu_gmrf_torch.solvers.base import TRI_LT

    B, n, vals, el = f.vals.shape[0], f.n, f.vals, f.vals.element_size()
    dp = sn._device_plan(f.meta, vals.device)
    L, _, _ = dense_factor(vals, f.meta)
    nnzL = vals.shape[1] - 1
    rng = np.random.default_rng(31)
    U = torch.tensor(rng.normal(size=(B, n, 16)), dtype=vals.dtype, device=vals.device)
    more = rng.normal(size=(B, n, max(TRANSPOSE_KS) - 16))
    U = torch.cat([U, torch.tensor(more, dtype=vals.dtype, device=vals.device)], -1)
    for k in TRANSPOSE_KS:
        rows, _ = f._rows(U[..., :k])
        yp_in = kernels.gather_segsum(dp["perm"], rows, y=1.0 / f._scale_rows(k))

        def transposed(mul, v, z=yp_in):
            out = torch.zeros_like(z)
            mul(v, dp["schedule"], out, z, k)
            return out

        run = lambda: transposed(kernels.sn_multiply_t, vals)  # noqa: E731
        yt = transpose_launches(run, kernels.sn_multiply_t, f"sn_multiply transpose k={k}")
        transpose_launches(lambda: f._tri(TRI_LT, U[..., :k]), kernels.sn_multiply_t,
                           f"Lᵀz through the factor k={k}")
        zr = yp_in[:, :n].reshape(B, k, -1).transpose(1, 2)
        ref = transposed(kernels.sn_multiply_t_plain, f64(vals), f64(yp_in))
        check(f"sn_multiply transpose k={k}", dtype, (yt,), (ref,), "sn_multiply_t",
              results if k == 16 and B > 1 else {}, cuda_ms(run),
              cuda_ms(lambda: transposed(kernels.sn_multiply_t_plain, vals), 2, 1),
              f" device_ms={kernel_device_ms(lambda: [run() for _ in range(REPS)], ('sn_multiply_t',), REPS):.4f} "
              f"a launch, {len(dp['schedule']['classes'])} class batches (library: the densified factor's "
              f"transpose times the permuted rows, one matmul)",
              (2 * B * k * nnzL, el * (B * nnzL + 2 * B * k * n)), cuda_ms(lambda: L.mT @ zr), shape + f" k={k}")


def check_sn_transpose_large(model, dtype, dev):
    """K7's mode 3 at phase 14's shape (B = 1, n = 14058), k = 16, 1 and 40 (`check_sn_transpose`)."""
    import tpu_gmrf_torch as tg

    f = tg.factorize(random_posterior(model, 1, dtype, dev, seed=32), tg.SolverSpec(kind="supernodal"))
    check_sn_transpose(f, dtype, {}, f"B=1 n={model.n}")


def check_adjoint_kernels(sp_model, dev, stats_model) -> dict:
    """Phase 3h: K23-K25 and the transpose modes of K13's second entry and K7 against their plain versions, in
    float32 and float64; K7's mode 3 also at phase 14's shape."""
    results = {}
    for dtype in (torch.float32, torch.float64):
        out = results if dtype == torch.float64 else {}
        check_tridiag_adjoint(dtype, dev, out)
        check_bt_adjoint(sp_model, dtype, dev, out)
        check_sn_adjoint(sp_model, dtype, dev, out)
        check_sn_transpose_large(stats_model, dtype, dev)
        check_bt_sqrt_t_wide(dtype, dev)
    return results


# ---- phase 24: second derivatives and the selected inverse's derivative ---------------------------


def theta_hessian(ml, p):
    """(value (B,), gradient (B, 2), Hessian (B, 2, 2)) of the per-chain function ml at p (B, 2): one gradient
    with create_graph=True, then a backward pass of each of its two components summed over the chains (the
    chains do not depend on each other), H[b, i, j] = ∂g_i/∂p_j."""
    p = p.detach().clone().requires_grad_()
    v = ml(p)
    (g,) = torch.autograd.grad(v.sum(), p, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[:, i].sum(), p, retain_graph=i == 0)[0] for i in range(2)], 1)
    return v.detach(), g.detach(), H


def theta_gradient(ml, p):
    p = p.detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(ml(p).sum(), p)
    return g


def hessian_checks(label, ml, p, ref_H, tol: dict, eps: float):
    """Holds the kernel path's Hessian at p against the plain f64 path's (ref_H), its symmetry, and the
    central difference of the kernel path's own gradient (step eps); returns the value, gradient, Hessian
    and seconds of one Hessian (the second call's)."""
    times = []
    for _ in range(2):  # the first call pays the new patterns' host plans; the second is the one reported
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, g, H = theta_hessian(ml, p)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    secs = times[1]
    if not bool(torch.isfinite(H).all()):
        raise AssertionError(f"{label}: non-finite Hessian")
    Hd, Rd = H.double().cpu(), ref_H.double().cpu()
    scale = Rd.abs().amax((-2, -1)).clamp_min(1e-300)
    plain = float(((Hd - Rd).abs().amax((-2, -1)) / scale).max())
    sym = float(((Hd - Hd.mT).abs().amax((-2, -1)) / scale).max())
    cols = [(theta_gradient(ml, p + eps * e) - theta_gradient(ml, p - eps * e)).double().cpu() / (2 * eps)
            for e in torch.eye(2, dtype=p.dtype, device=p.device)]
    cd = float(((Hd - torch.stack(cols, -1)).abs().amax((-2, -1)) / scale).max())
    log(f"  {label}: Hessian vs the f64 plain path max rel {plain:.3e} (tol {tol['plain']:.0e}), asymmetry "
        f"{sym:.3e} (tol {tol['sym']:.0e}), vs central differences of its own gradient (h={eps:g}) {cd:.3e} "
        f"(tol {tol['cd']:.0e}); one Hessian {secs * 1e3:.1f} ms (value+grad with create_graph=True and two "
        f"backward passes; first call {times[0] * 1e3:.1f} ms); H[0] = {Hd[0].flatten().tolist()}")
    if not (plain <= tol["plain"] and sym <= tol["sym"] and cd <= tol["cd"]):
        raise AssertionError(f"{label}: the θ-Hessian fails its checks")
    return v, g, H, secs


def flagship_marginal(y, dtype, dev):
    """laplace_marginal of AR1(N) + Poisson at θ = (log τ, atanh ρ) per chain, max_iter=GA_MAX_ITER."""
    import tpu_gmrf_torch as tg

    model, obs, opts = tg.AR1Model(N), tg.ExponentialFamily("poisson"), tg.GAOptions(max_iter=GA_MAX_ITER)
    yt = torch.tensor(y, dtype=dtype, device=dev)
    return lambda p: tg.laplace_marginal(model, obs, yt, {"tau": torch.exp(p[:, 0]), "rho": torch.tanh(p[:, 1])},
                                         options=opts)


def spatial_marginal(model, y, inner, dtype, dev):
    """laplace_marginal of phase 7's Matérn prior + Poisson at θ = (log τ, log range) per chain."""
    import tpu_gmrf_torch as tg

    opts = tg.GAOptions(max_iter=SP_GA_ITER) if inner is None else \
        tg.GAOptions(max_iter=SP_GA_ITER, inner_solver=tg.SolverSpec(kind=inner))
    obs, yt = tg.ExponentialFamily("poisson"), torch.tensor(y, dtype=dtype, device=dev)
    return lambda p: tg.laplace_marginal(model, obs, yt, {"tau": torch.exp(p[:, 0]), "range": torch.exp(p[:, 1])},
                                         options=opts)


def logpdf_hessian_check(dev):
    """Fault 3.4 on the card: the Hessian of GMRF.logpdf in x at the flagship's AR1(500) through K4, float64,
    against −Q (each column a backward pass of the gradient built with create_graph=True)."""
    import tpu_gmrf_torch as tg

    g = tg.AR1Model(N)(tau=torch.tensor(1.3, dtype=torch.float64, device=dev),
                       rho=torch.tensor(0.7, dtype=torch.float64, device=dev))
    x = torch.tensor(np.random.default_rng(24).normal(size=N), device=dev).requires_grad_()
    before = kernels_launches("csr_spmv")
    (gx,) = torch.autograd.grad(g.logpdf(x), x, create_graph=True)
    H = torch.stack([torch.autograd.grad(gx[i], x, retain_graph=True)[0] for i in range(N)])
    err = float((H + g.Q.todense()).abs().max() / g.Q.todense().abs().max())
    log(f"  fault 3.4: Hessian of GMRF.logpdf at AR1({N}) through K4 ({kernels_launches('csr_spmv') - before} K4 "
        f"launches), f64: max rel from −Q {err:.3e} (tol {HESS_TOL['logpdf']:.0e})")
    if not err <= HESS_TOL["logpdf"]:
        raise AssertionError("the Hessian of GMRF.logpdf is not −Q on the card")


def kernels_launches(name: str) -> int:
    from tpu_gmrf_torch import kernels

    return kernels.KERNELS[name].launches


def example13_path(dev):
    """Example 13 (examples/13_automatic_differentiation.py) on the card as it runs, float32: IID(50) + Poisson
    in (log τ, log μ) through the tridiagonal backend, with its own checks and limits."""
    import tpu_gmrf_torch as tg
    import torch.autograd.forward_ad as fwAD
    from tpu_gmrf_torch.sparse.matrix import speye

    n, tau_true, mu_true = 50, 4.0, 5.0
    rng = np.random.default_rng(123)
    x_latent = mu_true + rng.normal(size=n) / np.sqrt(tau_true)
    y = torch.tensor(rng.poisson(np.exp(np.clip(x_latent, -10, 10))), dtype=torch.float32, device=dev)
    obs = tg.ExponentialFamily("poisson")

    def objective(theta):
        prior = tg.GMRF.from_precision(torch.exp(theta[1]).expand(n), speye(n, torch.float32) * torch.exp(theta[0]))
        return -tg.marginal_loglikelihood(prior, obs(y))

    def grad(theta):
        t = theta.detach().clone().requires_grad_()
        return torch.autograd.grad(objective(t), t)[0]

    def hess(theta):
        return torch.autograd.functional.hessian(objective, theta)

    theta0 = torch.tensor([np.log(tau_true) + 0.2, np.log(mu_true) - 0.3], dtype=torch.float32, device=dev)
    g_rev = grad(theta0)
    g_fwd = []
    for i in range(2):
        with fwAD.dual_level():
            g_fwd.append(fwAD.unpack_dual(objective(fwAD.make_dual(theta0, torch.eye(2, device=dev)[i]))).tangent)
    g_fwd = torch.stack(g_fwd).cpu().numpy()
    g_rev = g_rev.cpu().numpy()
    np.testing.assert_allclose(g_rev, g_fwd, rtol=2e-3)
    eps = 1e-3
    fd = np.array([float(objective(theta0 + eps * e) - objective(theta0 - eps * e)) / (2 * eps)
                   for e in torch.eye(2, device=dev)])
    np.testing.assert_allclose(g_rev, fd, rtol=2e-2, atol=2e-3)
    H = hess(theta0).cpu().numpy()
    np.testing.assert_allclose(H, H.T, rtol=1e-3, atol=1e-4)
    H_fd = np.stack([(grad(theta0 + eps * e) - grad(theta0 - eps * e)).cpu().numpy() / (2 * eps)
                     for e in torch.eye(2, device=dev)])
    np.testing.assert_allclose(H, H_fd, rtol=5e-2, atol=0.5)
    theta, m, v = theta0.clone(), np.zeros(2), np.zeros(2)
    lr, b1, b2 = 0.05, 0.9, 0.999
    t0 = time.perf_counter()
    for it in range(1, 201):
        t = theta.detach().clone().requires_grad_()
        val = objective(t)
        g = torch.autograd.grad(val, t)[0].cpu().numpy().astype(np.float64)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = lr * (m / (1 - b1**it)) / (np.sqrt(v / (1 - b2**it)) + 1e-8)
        theta = theta - torch.tensor(step, dtype=torch.float32, device=dev)
    adam_s = time.perf_counter() - t0
    tau_opt, mu_opt = np.exp(theta.cpu().numpy())
    assert abs(np.log(mu_opt) - np.log(mu_true)) < 0.15
    assert abs(np.log(tau_opt) - np.log(tau_true)) < 1.5
    H_opt = hess(theta).cpu().numpy()
    assert np.linalg.eigvalsh(H_opt.astype(np.float64)).min() > 0
    log(f"  example 13 (f32): grad reverse {g_rev.tolist()}, forward {g_fwd.tolist()}, FD {fd.tolist()}; Hessian "
        f"{H.flatten().tolist()}; Adam (200 value+grads, {adam_s:.1f} s) -> (tau, mu) = ({tau_opt:.2f}, "
        f"{mu_opt:.2f}), -loglik {float(val.detach()):.3f}; eigenvalues of H at the optimum "
        f"{np.linalg.eigvalsh(H_opt.astype(np.float64)).tolist()}: the example's checks pass")


def sigma_gradient_path(stats_model, dev):
    """d/dθ of Σ_i var_i at n=14058, B=1 (phase 6's statistics, supernodal), θ = (log τ, log range), float64,
    against a central difference."""
    def total_var(p):
        g = stats_model(tau=torch.exp(p[0]), range=torch.exp(p[1]))
        return g.var().sum()

    p0 = torch.tensor([0.0, np.log(0.25)], dtype=torch.float64, device=dev)
    p = p0.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(total_var(p), p)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    h = 1e-4
    with torch.no_grad():
        cd = torch.stack([(total_var(p0 + h * e) - total_var(p0 - h * e)) / (2 * h)
                          for e in torch.eye(2, dtype=torch.float64, device=dev)])
    err = float((g - cd).abs().max() / cd.abs().max())
    log(f"  d/dθ Σ var_i at n={stats_model.n}, B=1, supernodal, f64: {g.tolist()} against the central difference "
        f"(h={h:g}) {cd.tolist()}: max rel {err:.3e} (tol {HESS_TOL['var_cd']:.0e}); {secs * 1e3:.1f} ms for "
        f"var and its gradient")
    if not err <= HESS_TOL["var_cd"]:
        raise AssertionError("the gradient of Σ var_i disagrees with its central difference")


def auto_solver(model):
    """A copy of `model` whose own solver is auto (phases 10-11 keep the supernodal prior)."""
    import copy

    import tpu_gmrf_torch as tg

    out = copy.copy(model)
    out.solver = tg.SolverSpec()
    return out


def hessian_path(sp_model, dn_model, stats_model, dev, card):
    """Phase 24: the θ-Hessians of the flagship (f32 and f64), example 13, the spatial slice (supernodal and
    auto -> banded, f64) and the g=16 slice (auto -> dense, f64), and the gradient of Σ var_i at n=14058; each
    path's kernels counted from zero and required to have launched."""
    from tpu_gmrf_torch import kernels

    counts = {}

    def run(label, kernel_path, fn):
        kernels.reset_launches()
        out = fn()
        got = kernels.launches()
        launched(got, kernel_path, label)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return out

    # (1) the flagship
    y = flagship_y()
    p = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(CHAINS, 2)), dtype=torch.float64)
    t0 = time.perf_counter()
    ref_H = theta_hessian(flagship_marginal(y, torch.float64, "cpu"), p)[2]
    plain_s = time.perf_counter() - t0
    run("flagship θ-Hessian", HESSIAN_FLAGSHIP_KERNELS, lambda: (
        logpdf_hessian_check(dev),
        hessian_checks(f"flagship f64 (B={CHAINS}, n={N})", flagship_marginal(y, torch.float64, dev), p.to(dev),
                       ref_H, HESS_TOL["f64"], 1e-3),
        hessian_checks(f"flagship f32 (B={CHAINS}, n={N})", flagship_marginal(y, torch.float32, dev),
                       p.float().to(dev), ref_H, HESS_TOL["f32"], 1e-2)))
    log(f"  (the flagship's f64 plain Hessian took {plain_s:.1f} s on the host CPU) on {card}")
    # (2) example 13
    run("example 13", HESSIAN_EX13_KERNELS, lambda: example13_path(dev))
    # (3) the spatial slice, f64, supernodal and auto -> banded
    sp_y = spatial_y(sp_model, SP_GRID)
    sp_p = torch.tensor(np.tile([0.0, np.log(0.3)], (SP_CHAINS, 1))
                        + np.random.default_rng(5).normal(scale=0.3, size=(SP_CHAINS, 2)), dtype=torch.float64)
    for model, inner, path in ((sp_model, "supernodal", HESSIAN_SPATIAL_KERNELS),
                               (auto_solver(sp_model), None, HESSIAN_BANDED_KERNELS)):
        t0 = time.perf_counter()
        ref = theta_hessian(spatial_marginal(model, sp_y, inner, torch.float64, "cpu"), sp_p)[2]
        plain_s = time.perf_counter() - t0
        kind = inner or f"auto -> {tg_resolve(model)}, prior and inner"
        run(f"spatial θ-Hessian ({kind})", path, lambda: hessian_checks(
            f"spatial f64 (B={SP_CHAINS}, n={model.n}, {kind})",
            spatial_marginal(model, sp_y, inner, torch.float64, dev), sp_p.to(dev), ref, HESS_TOL["spatial"], 1e-3))
        log(f"  (its f64 plain Hessian took {plain_s:.1f} s on the host CPU) on {card}")
    # (4) g=16 on the dense backend (auto), and the gradient of Σ var_i at n=14058
    dn_model = auto_solver(dn_model)
    dn_y = spatial_y(dn_model, DN_GRID)
    dn_p = torch.tensor(np.tile([0.0, np.log(0.3)], (DN_CHAINS, 1))
                        + np.random.default_rng(6).normal(scale=0.3, size=(DN_CHAINS, 2)), dtype=torch.float64)
    ref = theta_hessian(spatial_marginal(dn_model, dn_y, None, torch.float64, "cpu"), dn_p)[2]
    run(f"g={DN_GRID} θ-Hessian (auto -> {tg_resolve(dn_model)})", HESSIAN_DENSE_KERNELS, lambda: hessian_checks(
        f"g={DN_GRID} f64 (B={DN_CHAINS}, n={dn_model.n}, auto -> {tg_resolve(dn_model)}, prior and inner)",
        spatial_marginal(dn_model, dn_y, None, torch.float64, dev), dn_p.to(dev), ref, HESS_TOL["g16"], 1e-3))
    run("Σ var gradient", HESSIAN_VAR_KERNELS, lambda: sigma_gradient_path(stats_model, dev))
    return counts


# ---- phase 25: pathwise gradients through the factor ------------------------------------------------------


def poisson_draws(y):
    """f(x) = Σ_i y_i x_i − exp(x_i) of draws x (k, B, n), averaged over the k draws: (B,)."""
    return lambda x: (y * x - torch.exp(x)).sum(-1).mean(0)


def draw_objective(build, y, z, zq=None, w=None, sample=None):
    """θ ↦ (1/k) Σ_k f(μ + L⁻ᵀ z_k) per chain, f the Poisson log-likelihood, for the GMRF `build(θ)` and fixed noise
    z (k, B, n) (GMRF.sample's formula), or, with `sample` = (device, seed), through GMRF.sample itself, its
    generator reseeded at each call; with zq and w (B, n, 4), plus Σ w·(L zq) per chain (sqrt_matvec)."""
    f = poisson_draws(y)

    def run(p):
        g = build(p)
        if sample is None:
            x = g.mean + g.factor.backward_solve(z.movedim(0, -1).contiguous()).movedim(-1, 0)
        else:
            x = g.sample(torch.Generator(device=sample[0]).manual_seed(sample[1]), (z.shape[0],))
        v = f(x)
        return v if zq is None else v + (g.factor.sqrt_matvec(zq) * w).sum((-2, -1))

    return run


def sample_noise(g, dev, seed: int, k: int = PATH_DRAWS):
    """The noise GMRF.sample draws for g with a generator on `dev` seeded `seed`: (k, *batch, n)."""
    return torch.randn((k, *g.factor.batch_shape, g.n), generator=torch.Generator(device=dev).manual_seed(seed),
                       dtype=g.dtype, device=dev)


def path_grads(fn, p, zq=None):
    """(values (B,), ∂/∂p (B, d), ∂/∂zq or None) of the per-chain function fn; the chains are independent."""
    p = p.detach().clone().requires_grad_()
    v = fn(p)
    inputs = (p,) if zq is None else (p, zq)
    got = torch.autograd.grad(v.sum(), inputs)
    return v.detach(), got[0], (got[1] if zq is not None else None)


def grad_rel_chains(got, ref) -> torch.Tensor:
    """Per chain |got − ref| / max(|ref|, 1), normwise: (B,) on the host."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return (got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1.0)


def grad_rel(got, ref) -> float:
    """Max over chains of `grad_rel_chains`."""
    return float(grad_rel_chains(got, ref).max())


def plain_prior(m):
    """θ ↦ the GMRF of m(tau=e^θ0, range=e^θ1) whose supernodal factor runs the plain versions whatever the
    device (`_factorize` with _PLAIN_OPS), its solves and its gradient through them too."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.solvers import supernodal as sn

    def build(pp):
        th = dict(tau=torch.exp(pp[:, 0]), range=torch.exp(pp[:, 1]))
        Q = m.precision(**th)
        spec = m.solver
        return tg.GMRF(mean=m.mean(**th), Q=Q, factor=sn._factorize(Q, spec.max_width, spec.ordering, sn._PLAIN_OPS),
                       solver=spec)

    return build


def central_difference(fn, p, h: float):
    """Per chain ∂fn/∂p_j by (fn(p + h e_j) − fn(p − h e_j)) / 2h, the chains independent: (B, d)."""
    cols = []
    with torch.no_grad():
        for j in range(p.shape[1]):
            e = torch.zeros_like(p)
            e[:, j] = h
            cols.append((fn(p + e) - fn(p - e)) / (2 * h))
    return torch.stack(cols, -1)


def pathwise_cell(label, build, y, p, dev, seed, tol, cd_tol, f32=False, sqrt=False, plain_build=None):
    """One cell of phase 25: the kernel path's per-chain gradient through GMRF.sample (k draws from a generator on
    the card), and with `sqrt` also of Σ w·(L zq) in θ and in zq (zq̄ = Lᵀw: the transpose modes), against the f64
    plain path (the same noise, CPU tensors) and, at the fixed noise, a central difference. With `f32`, the float32
    kernel path against the f64 plain path, held to twice the float32 plain path's own distance from it plus
    PATHWISE_TOL's floor: the plain path on CPU tensors, or with `plain_build` (the same GMRF on the plain versions)
    on the card, per chain, for the chains whose factor the kernels did not boost, the boosted chains required to be
    those the plain versions boost on the same inputs. Returns the launches of the transpose products bt_sqrt_t and
    sn_multiply_t in the backward."""
    from tpu_gmrf_torch import kernels

    y64 = torch.as_tensor(y, dtype=torch.float64)
    g0 = build(p.to(dev))
    z = sample_noise(g0, dev, seed)
    zq = w = None
    if sqrt:
        rng = np.random.default_rng(seed)
        zq, w = (torch.tensor(rng.normal(size=(*g0.factor.batch_shape, g0.n, 4)), dtype=torch.float64) for _ in range(2))
    on = (lambda t: None if t is None else t.to(dev))  # noqa: E731
    zqd = None if zq is None else zq.to(dev).requires_grad_()
    fn = draw_objective(build, y64.to(dev), z, zqd, on(w), sample=(dev, seed))
    pp = p.to(dev).detach().clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = fn(pp)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = [kernels.bt_sqrt_t.launches, kernels.sn_multiply_t.launches]
    grads = torch.autograd.grad(v.sum(), (pp,) if zqd is None else (pp, zqd))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    back = [a - b for a, b in zip((kernels.bt_sqrt_t.launches, kernels.sn_multiply_t.launches), before)]
    v, g, gz = v.detach(), grads[0], (grads[1] if sqrt else None)
    zqp = None if zq is None else zq.clone().requires_grad_()
    vp, gp, gzp = path_grads(draw_objective(build, y64, z.cpu(), zqp, w), p, zqp)
    cd = central_difference(draw_objective(build, y64.to(dev), z, on(zq), on(w)), p.to(dev), PATHWISE_H)
    errs = {"value": float(((v.cpu() - vp).abs() / vp.abs()).max()), "grad": grad_rel(g, gp), "cd": grad_rel(g, cd)}
    if sqrt:
        errs["zq"] = float((gz.cpu() - gzp).abs().max() / gzp.abs().max())
    line = (f"  {label}: value {(t1 - t0) * 1e3:.1f} ms, its backward {(t2 - t1) * 1e3:.1f} ms on the host clock; "
            + ", ".join(f"{k} rel {errs[k]:.3e}" for k in errs if k != "cd")
            + f" from the f64 plain path (tol {tol:.0e}); gradient {errs['cd']:.3e} from a central difference at "
              f"h={PATHWISE_H:g} (tol {cd_tol:.0e})")
    ok = all(errs[k] <= tol for k in errs if k != "cd") and errs["cd"] <= cd_tol
    if sqrt:
        line += f"; the backward's launches of bt_sqrt_t / sn_multiply_t {back[0]} / {back[1]}"
    if f32:
        z32 = z.float()
        zq32 = None if zq is None else zq.float().requires_grad_()
        w32 = None if w is None else w.float()
        v32, g32, _ = path_grads(draw_objective(build, y64.float().to(dev), z32, on(zq32), on(w32)), p.float().to(dev))
        v32p, g32p, _ = path_grads(draw_objective(build, y64.float(), z32.cpu(), zq32, w32), p.float())
        finite = bool(torch.isfinite(g32).all() and torch.isfinite(v32).all())
        if plain_build is None:
            e32, e32p = grad_rel(g32, gp), grad_rel(g32p, gp)
            lim = PATHWISE_TOL["f32_factor"] * e32p + PATHWISE_TOL["f32_floor"]
            line += (f"; f32 kernel path {e32:.3e} from the f64 plain path (limit {lim:.3e}: twice the f32 plain "
                     f"path's {e32p:.3e}, plus {PATHWISE_TOL['f32_floor']:.0e})")
            ok = ok and finite and e32 <= lim
        else:
            _, g32c, _ = path_grads(draw_objective(plain_build, y64.float().to(dev), z32, on(zq32), on(w32)),
                                    p.float().to(dev))
            with torch.no_grad():
                boost = {"kernels": build(p.float().to(dev)).factor.boost.cpu(),
                         "plain on the card": plain_build(p.float().to(dev)).factor.boost.cpu(),
                         "plain on CPU tensors": build(p.float()).factor.boost}
                f64_piv = g0.factor.vals[:, torch.as_tensor(g0.factor.plan["diag_pos"], device=dev)].square()
            ek, ec, eh = (grad_rel_chains(g, gp) for g in (g32, g32c, g32p))
            held = boost["kernels"] == 0
            lim = PATHWISE_TOL["f32_factor"] * ec + PATHWISE_TOL["f32_floor"]
            same = bool(torch.equal(boost["kernels"] > 0, boost["plain on the card"] > 0))
            fmt = lambda t: "[" + ", ".join(f"{float(x):.3e}" for x in t) + "]"  # noqa: E731
            line += (f"; f32 per chain from the f64 plain path: kernel path {fmt(ek)}, plain path on the card "
                     f"{fmt(ec)}, on CPU tensors {fmt(eh)}; held where the kernels boosted no pivot, at twice the "
                     f"plain path on the card plus {PATHWISE_TOL['f32_floor']:.0e}: limits {fmt(lim)}, chains "
                     f"{held.nonzero().flatten().tolist()}; pivot boosts "
                     + ", ".join(f"{k} {v.tolist()}" for k, v in boost.items())
                     + f" (the same chains: {same}); f64 smallest scaled pivot per chain "
                       f"{fmt(f64_piv.amin(-1).cpu())}")
            ok = (ok and finite and bool(torch.isfinite(g32c).all()) and same and bool(held.any())
                  and bool((ek[held] <= lim[held]).all()))
    log(line)
    if not ok:
        raise AssertionError(f"phase 25 {label}: the pathwise gradient disagrees")
    return back


def mc_routes(p, dev):
    """(d): the flagship's mean over draws of ∂/∂θ Σ_i x_i² (pathwise, through GMRF.sample) against ∂/∂θ Σ_i var_i
    (SelectedInverse), per chain and component, within PATHWISE_TOL['mc'] Monte Carlo standard errors (from the
    spread of MC_CHUNKS chunk means of MC_DRAWS draws each)."""
    import tpu_gmrf_torch as tg

    model = tg.AR1Model(N)

    def build(pp):
        return model(tau=torch.exp(pp[:, 0]), rho=torch.tanh(pp[:, 1]))

    pd = p.to(dev)
    _, exact, _ = path_grads(lambda pp: build(pp).var().sum(-1), pd)
    gen = torch.Generator(device=dev).manual_seed(26)
    t0 = time.perf_counter()
    chunks = []
    for _ in range(MC_CHUNKS):
        pp = pd.detach().clone().requires_grad_()
        x = build(pp).sample(gen, (MC_DRAWS,))
        (gc,) = torch.autograd.grad((x * x).sum(-1).mean(0).sum(), pp)
        chunks.append(gc)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    G = torch.stack(chunks)
    mean, se = G.mean(0), G.std(0) / MC_CHUNKS**0.5
    z = ((mean - exact).abs() / se).cpu()
    log(f"  (d) flagship E ∂Σx²/∂θ pathwise ({MC_CHUNKS} x {MC_DRAWS} draws a chain, {secs:.1f} s) against ∂Σvar/∂θ "
        f"(SelectedInverse): max |Δ| {float(z.max()):.2f} Monte Carlo standard errors over {z.numel()} (chain, θ) "
        f"pairs, mean {float(z.mean()):.2f} (limit {PATHWISE_TOL['mc']:g})")
    if not float(z.max()) <= PATHWISE_TOL["mc"]:
        raise AssertionError("phase 25 (d): the pathwise and the selected-inverse derivatives disagree")


def spike_grad_cell(dn_model, dev, card):
    """(e): the SPIKE logdet's gradient at phase 17's shape (P=4 chunks, f64) against a five-point central difference
    along a random direction; `_Ranks` on a one-rank NCCL mesh against `_Chunks`; the solve's Hessian-vector product against
    the f64 plain path on CPU tensors."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.parallel.pbtridiag import _pbtridiag_chunks

    diag, sub, b = spike_system(dn_model, torch.float64, dev)
    Nt, ns = b.shape
    rng = np.random.default_rng(252)
    vd = torch.tensor(rng.normal(size=(Nt, ns, ns)), dtype=torch.float64, device=dev)
    vd = 0.5 * (vd + vd.mT)
    vs = torch.tensor(rng.normal(size=tuple(sub.shape)), dtype=torch.float64, device=dev)
    vb = torch.tensor(rng.normal(size=(Nt, ns)), dtype=torch.float64, device=dev)
    scale = 1e-3 * float(diag.abs().max())
    vd, vs = vd * scale, vs * scale
    td, ts = diag.clone().requires_grad_(), sub.clone().requires_grad_()
    t0 = time.perf_counter()
    _, ld = _pbtridiag_chunks(td, ts, b, SPIKE_P)
    gd, gs = torch.autograd.grad(ld, (td, ts))
    torch.cuda.synchronize()
    ld_s = time.perf_counter() - t0
    deriv = float((gd * vd).sum() + (gs * vs).sum())
    h = SPIKE_CD_H

    def at(t):
        with torch.no_grad():
            return float(_pbtridiag_chunks(diag + t * vd, sub + t * vs, b, SPIKE_P)[1])

    # the five-point difference: the two-point one is 2.3e-5 off here by its h² term (the direction nears the
    # matrix's indefinite edge: at 100h it is indefinite), the five-point one 6e-9 (on CPU tensors)
    cd = (at(-2 * h) - 8 * at(-h) + 8 * at(h) - at(2 * h)) / (12 * h)
    cd_err = abs(deriv - cd) / abs(cd)
    with socket.socket() as sock:  # a free port on this host for the one-rank process group
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("time",))
        rd, rs = diag.clone().requires_grad_(), sub.clone().requires_grad_()
        gdr, gsr = torch.autograd.grad(tg.pbtridiag_logdet(rd, rs, mesh), (rd, rs))
        ranks_err = max(float((gdr - gd).norm() / gd.norm()), float((gsr - gs).norm() / gs.norm()))
    finally:
        dist.destroy_process_group()

    def hvp(d, s, bb, dirs, P):
        leaves = [t.detach().clone().requires_grad_() for t in (d, s, bb)]
        x, _ = _pbtridiag_chunks(*leaves, P)
        grads = torch.autograd.grad((x * x).sum(), leaves, create_graph=True)
        return torch.autograd.grad(sum((g * v).sum() for g, v in zip(grads, dirs)), leaves)

    t0 = time.perf_counter()
    hk = hvp(diag, sub, b, (vd, vs, vb), SPIKE_P)
    torch.cuda.synchronize()
    hvp_s = time.perf_counter() - t0
    hp = hvp(*(t.cpu() for t in (diag, sub, b)), tuple(v.cpu() for v in (vd, vs, vb)), SPIKE_P)
    hvp_err = max(float((a.cpu() - c).norm() / c.norm()) for a, c in zip(hk, hp))
    log(f"  (e) SPIKE Nt={Nt} ns={ns} P={SPIKE_P} f64: logdet + its gradient {ld_s * 1e3:.1f} ms; directional "
        f"derivative {deriv:.9e} vs five-point difference {cd:.9e}, rel {cd_err:.3e} (tol {PATHWISE_TOL['spike_cd']:.0e}); "
        f"one-rank NCCL _Ranks vs _Chunks rel {ranks_err:.3e} (tol {PATHWISE_TOL['ranks']:.0e}); the solve's "
        f"Hessian-vector product {hvp_s * 1e3:.1f} ms, rel {hvp_err:.3e} from the f64 plain path (tol "
        f"{PATHWISE_TOL['hvp']:.0e}); on {card}")
    if not (cd_err <= PATHWISE_TOL["spike_cd"] and ranks_err <= PATHWISE_TOL["ranks"]
            and hvp_err <= PATHWISE_TOL["hvp"]):
        raise AssertionError("phase 25 (e): the SPIKE derivatives disagree")


def pathwise_path(sp_model, dn_model, dev, card):
    """Phase 25: gradients through GMRF.sample and sqrt_matvec on every direct backend, the two derivative routes,
    and the SPIKE logdet's gradient and solve's Hessian; the kernels counted from zero and required to have
    launched on each cell."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels

    counts = {}

    def run(label, kernel_path, fn):
        kernels.reset_launches()
        out = fn()
        got = kernels.launches()
        launched(got, kernel_path, label)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return out

    # (a) the flagship: AR1(500), 256 chains, θ = (log τ, atanh ρ) at phase 4's draws
    y = flagship_y()
    model = tg.AR1Model(N)

    def ar1(pp):
        return model(tau=torch.exp(pp[:, 0]), rho=torch.tanh(pp[:, 1]))

    p = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(CHAINS, 2)), dtype=torch.float64)
    run("pathwise flagship", PATHWISE_FLAGSHIP_KERNELS, lambda: pathwise_cell(
        f"(a) flagship (B={CHAINS}, n={N}, k={PATH_DRAWS} draws, f64 and f32)", ar1, y, p, dev, 25,
        PATHWISE_TOL["f64"], PATHWISE_TOL["cd"], f32=True))
    # (b) the spatial prior at n=5741: supernodal (f64, f32), then auto -> banded (f64); with sqrt_matvec
    sp_y = spatial_y(sp_model, SP_GRID)
    sp_p = torch.tensor(np.tile([0.0, np.log(0.3)], (SP_CHAINS, 1))
                        + np.random.default_rng(7).normal(scale=0.3, size=(SP_CHAINS, 2)), dtype=torch.float64)

    def prior(m):
        return lambda pp: m(tau=torch.exp(pp[:, 0]), range=torch.exp(pp[:, 1]))

    banded = auto_solver(sp_model)
    for m, kind, path, mode in ((sp_model, "supernodal", PATHWISE_SN_KERNELS, 1),
                                (banded, f"auto -> {tg_resolve(banded)}", PATHWISE_BANDED_KERNELS, 0)):
        sn_cell = m is sp_model
        back = run(f"pathwise spatial {kind}", path, lambda: pathwise_cell(
            f"(b) spatial (B={SP_CHAINS}, n={m.n}, {kind}, k={PATH_DRAWS}, f64{' and f32' if sn_cell else ''}, "
            f"with sqrt_matvec)", prior(m), sp_y, sp_p, dev, 27, PATHWISE_TOL["spatial"], PATHWISE_TOL["cd_spatial"],
            f32=sn_cell, sqrt=True, plain_build=plain_prior(m) if sn_cell else None))
        if dev.type == "cuda" and back[mode] == 0:  # (CPU tensors launch nothing)
            raise AssertionError(f"phase 25 {kind}: sqrt_matvec's backward launched no transpose mode")
    # (c) g=16 on the dense backend (auto), f64
    dn = auto_solver(dn_model)
    dn_y = spatial_y(dn, DN_GRID)
    dn_p = torch.tensor(np.tile([0.0, np.log(0.3)], (DN_CHAINS, 1))
                        + np.random.default_rng(8).normal(scale=0.3, size=(DN_CHAINS, 2)), dtype=torch.float64)
    run(f"pathwise g={DN_GRID}", PATHWISE_DENSE_KERNELS, lambda: pathwise_cell(
        f"(c) g={DN_GRID} (B={DN_CHAINS}, n={dn.n}, auto -> {tg_resolve(dn)}, k={PATH_DRAWS}, f64, with sqrt_matvec)",
        prior(dn), dn_y, dn_p, dev, 28, PATHWISE_TOL["spatial"], PATHWISE_TOL["cd_spatial"], sqrt=True))
    # (d) two derivative routes on the flagship, (e) SPIKE
    run("pathwise MC routes", PATHWISE_MC_KERNELS, lambda: mc_routes(p, dev))
    run("SPIKE derivatives", PATHWISE_SPIKE_KERNELS, lambda: spike_grad_cell(dn_model, dev, card))
    return counts


# ---- phase 26: space-time and FEM breadth ----------------------------------------
# Phase 26: the FEM slice (fem/mesh.py, discretization.py, spatiotemporal.py, obs_models.py; supernodal
# solve_refined) on the card, f64 unless the example runs f32. (a) Example 04 as written: the advection-diffusion
# joint (Nx=201, Nt=71, n=14,271), linear_condition on 101 observations, its assertions and golden literals
# (tools/golden_values.py:120), the posterior mean against the plain path on the card (Q_post x = Aᵀ Q_ε y by the
# plain versions of the backend on CUDA tensors). (b) The full-width 2-D path: AdvectionDiffusionSPDE on phase 10's g=16
# mesh (ns=450), γ=(0.6, 0.3), α=1, Neumann (ST_SPDE), ST_NT time steps; discretize, the Laplace approximation with Poisson
# counts drawn (seeded generator) from one prior draw at every node of every ST_OBS_EVERY-th step, the posterior's
# time_means, time_stds (selected inverse) and ST_DRAWS time_rands; the joint Q against its assembly on CPU tensors,
# the Newton mode against the Laplace approximation whose factorizations and solves are the plain versions
# of the backend on the card, the stds against the plain selected inverse on the card, the draws' means and variances against the
# posterior mean and variance by per-node tests at a Bonferroni family-wise level FEM_DRAW_LEVEL. (c) Example 11 as
# written, dense: its assertions and four golden literals (tools/golden_values.py:288). (d) Example 14 as written on
# icosphere(3), supernodal: its assertions and literals (tools/golden_values.py:328), and solve_refined against the
# plain solve on the card. (e) Example 15 as written (580 points, Bernoulli through PointEvaluationObsModel, f32):
# its assertions. "The plain path on the card" runs the same backend on the plain versions (`plain_direct`). The
# tolerances: Q rel 1e-12 (the same products in another summation order); each f64 solution's relative residual
# (backward error) 1e-13, ~450 ε: the plain versions read 5.4e-16 on example 04 (card), a backward-stable solve
# stays within a few hundred ε of that, while K11/K12 read 6.0e-11 there when they multiplied by inverted
# diagonal tiles and blocks; a solution's distance from the plain path's at FEM_TOL["forward"] (10) times κ·ε, κ
# the equilibrated condition estimated with the plain path's factor (`equilibrated_condition`, so that the
# factor under test does not set its own limit): example 04's posterior has κ ≈ 7.7e13 (scipy's eigsh on CPU
# tensors), so its mean is only known to ~1e-2 whatever the solver (two backward-stable solves land 1.3e-3
# apart), as its golden literals' 5e-3 limits say; (b)'s Newton mode and stds at the larger of 1e-8 and that
# bound; solve_refined rel 1e-10.
ST_NT, ST_OBS_EVERY, ST_DRAWS, ST_SEED = 128, 4, 16, 26
# (b)'s SPDE: the spatial noise and initial state at range 0.3 (κ_s = √(8ν)/0.3, ν = 2), propagation κ = 3 and
# τ = 10, so that the field's variance stays O(1) over [0, 1] (0.7-2.5 at the last step; the initial state's
# 1-3.9). The class defaults (κ_s = κ = 1: range 4 on the unit square) give a joint that is numerically singular
# in float64 (an equilibrated eigenvalue below zero at Nt = 8); this one's equilibrated condition is ~1.5e9 at
# Nt = 8 and 32 (numpy's eigvalsh on CPU tensors).
ST_SPDE = dict(gamma=(0.6, 0.3), alpha=1, kappa=3.0, tau=10.0, spatial_kappa=4.0 / 0.3)
FEM_TOL = {"Q": 1e-12, "residual": 1e-13, "forward": 10.0, "mode": 1e-8, "std": 1e-8, "refined": 1e-10}
FEM_DRAW_LEVEL = 1e-3
FEM_BASE_KERNELS = ("csr_spmv", "gather_segsum")
SELINV_KERNELS = ("sn_takahashi_prep", "sn_takahashi")
EX04_GOLD = {"t=0 fit rmse": (0.00209, 0.005), "t=2T/3 fit": (0.54997, 0.005), "t=2T/3 peak": (-0.44, 0.05)}
EX11_GOLD = {"Neumann var[0]": (0.605518, 2e-3), "Neumann var[mid]": (0.302768, 2e-3),
             "Dirichlet std[mid]": (0.550227, 2e-3), "AD-SPDE std[4, mid]": (0.072161, 1e-3)}
EX14_GOLD = {"median var": (1.124293, 1e-2), "near-pole corr": (0.756208, 1e-2)}


def held(label: str, got: float, gold: float, lim: float, bad: list) -> None:
    ok = abs(got - gold) < lim
    bad += [] if ok else [label]
    log(f"    {label} {got:.6f}, golden {gold:.6f} ± {lim:g}: {'ok' if ok else 'MISSED'}")


def asserted(label: str, ok: bool, bad: list) -> None:
    bad += [] if ok else [label]
    log(f"    {label}: {'ok' if ok else 'FAILED'}")


def plain_direct():
    """A context in which every supernodal and banded factorization, its solves and its selected inverse run the
    plain versions, whatever the device (the public API has no such option)."""
    import contextlib
    from unittest import mock

    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.solvers import banded as bd
    from tpu_gmrf_torch.solvers import supernodal as sn

    sigma = bd._sigma_vals
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(sn, "supernodal_factorize", lambda Q, max_width=2048, ordering="auto",
                                          mesh=None: sn._factorize(Q, max_width, ordering, sn._PLAIN_OPS)))
    stack.enter_context(mock.patch.object(bd, "_sigma_vals", lambda P, meta, ops=None: sigma(
        P, meta, (kernels.sn_takahashi_prep_plain, kernels.sn_takahashi_sweep_plain))))
    for name in ("bt_factor", "bt_trsv", "gather_segsum"):
        stack.enter_context(mock.patch.object(bd, name, getattr(kernels, f"{name}_plain")))
    return stack


def equilibrated_condition(Q, factor, iters: int = 60) -> float:
    """κ of D Q D (D = diag(Q)^-1/2) estimated by `iters` power and inverse-power steps (the latter by `factor`)."""
    d = Q.diagonal().rsqrt()
    gen = torch.Generator(device=Q.device).manual_seed(1)
    hi, lo = (torch.randn(Q.shape[0], generator=gen, dtype=Q.dtype, device=Q.device) for _ in range(2))
    for _ in range(iters):
        hi = d * Q.matvec(d * hi)
        hi = hi / hi.norm()
        lo = d.reciprocal() * factor.solve(d.reciprocal() * lo)
        lo = lo / lo.norm()
    lam_max = float(hi @ (d * Q.matvec(d * hi)))
    lam_min = 1.0 / float(lo @ (d.reciprocal() * factor.solve(d.reciprocal() * lo)))
    return lam_max / lam_min


def relative_residual(Q, x, b) -> float:
    """‖Qx − b‖∞ / (‖Q‖∞‖x‖∞ + ‖b‖∞), Qx by CSR torch.sparse.mm (not the port's K4)."""
    rows = torch.tensor(Q.pattern.rows, dtype=torch.long, device=Q.device)
    cols = torch.tensor(Q.pattern.cols, dtype=torch.long, device=Q.device)
    Qc = torch.sparse_coo_tensor(torch.stack([rows, cols]), Q.data, Q.shape, check_invariants=False).to_sparse_csr()
    r = (Qc @ x[:, None])[:, 0] - b
    qn = float(torch.zeros(Q.shape[0], dtype=Q.dtype, device=Q.device).index_add_(0, rows, Q.data.abs()).max())
    return float(r.abs().max()) / (qn * float(x.abs().max()) + float(b.abs().max()))


def run_ex04(dev):
    """Example 04 as written, float64: the values its checks read, the prior, the posterior and (A, y, Q_ε)."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.fem import AdvectionDiffusionSPDE, FEMDiscretization, interval_mesh, spatial_to_spatiotemporal
    from tpu_gmrf_torch.inference.joint import sp_bmat

    Nx, Nt = 201, 71
    d = FEMDiscretization(interval_mesh(-1, 1, Nx))
    spde = AdvectionDiffusionSPDE(d, gamma=[0.6], H=0.1, kappa=1.0, alpha=1, c=1.0, tau=3.0,
                                  spatial_kappa=float(np.sqrt(8.0) / 0.4))
    ts = np.linspace(0.0, 1.0, Nt)
    X = spde.discretize(ts)
    xs_initial = np.linspace(-1, 1, 100)
    f_initial = np.exp(-((xs_initial + 0.6) ** 2) / 0.2**2)
    A_init = spatial_to_spatiotemporal(d.evaluation_matrix(xs_initial[:, None]), 0, Nt)
    t_later = 2 * Nt // 3
    A_later = spatial_to_spatiotemporal(d.evaluation_matrix(np.array([[-0.25]])), t_later, Nt)
    A_all = sp_bmat([[A_init], [A_later]])
    y_all = np.concatenate([f_initial, [0.55]])
    prec = np.concatenate([np.full(len(f_initial), 0.1**-2), [0.01**-2]])
    post = tg.linear_condition(X.gmrf, y_all, Q_eps=post_qeps(prec, dev), A=A_all)
    means = post.mean.cpu().numpy().reshape(Nt, Nx)
    nodes = d.mesh.nodes
    fit0 = A_init.matvec(post.mean).cpu().numpy()
    vals = {"t=0 fit rmse": float(np.sqrt(np.mean((fit0 - f_initial) ** 2))), "t=0 peak": float(nodes[np.argmax(means[0])]),
            "t=2T/3 fit": float(A_later.matvec(post.mean).cpu()[0]),
            "t=2T/3 peak": float(nodes[np.argmax(means[t_later])])}
    return vals, X, post, (A_all, y_all, prec)


def ex04_cell(dev, card, counts: dict) -> list:
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # ---- example 04's path ----
    vals, X, post, (A, y, prec) = run_ex04(dev)
    torch.cuda.synchronize()
    got = kernels.launches()
    # ---- end of example 04's path ----
    secs = time.perf_counter() - t0
    kind = tg.SolverSpec().resolve(X.Q.pattern).kind
    launched(got, FEM_BASE_KERNELS + BACKEND_KERNELS[kind] + ("dense_chol",), "example 04")
    counts.update({k: counts.get(k, 0) + v for k, v in got.items()})
    log(f"  (a) example 04: n={X.n}, nnz(Q)={X.Q.nnz}, SolverSpec() -> {kind} for the joint and the posterior, "
        f"{secs:.2f} s on {card}")
    bad = []
    asserted(f"t=0 fit rmse {vals['t=0 fit rmse']:.4f} < 0.05", vals["t=0 fit rmse"] < 0.05, bad)
    asserted(f"t=0 peak at {vals['t=0 peak']:.3f} within 0.05 of -0.6", abs(vals["t=0 peak"] + 0.6) < 0.05, bad)
    asserted(f"t=2T/3 fit {vals['t=2T/3 fit']:.4f} within 0.01 of 0.55", abs(vals["t=2T/3 fit"] - 0.55) < 0.01, bad)
    asserted(f"t=2T/3 peak {vals['t=2T/3 peak']:.3f} in (-0.6, -0.1)", -0.6 < vals["t=2T/3 peak"] < -0.1, bad)
    for key, (gold, lim) in EX04_GOLD.items():
        held(key, vals[key], gold, lim, bad)
    # the plain path on the card: the same posterior on the plain versions
    t0 = time.perf_counter()
    with plain_direct():
        plain_post = tg.linear_condition(X.gmrf, y, Q_eps=post_qeps(prec, dev), A=A)
        xp = plain_post.mean
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        kappa = equilibrated_condition(post.Q, plain_post.factor)
    b = A.todense().T @ torch.tensor(prec * y, dtype=torch.float64, device=dev)  # Aᵀ Q_ε y; the prior mean is 0
    if float(X.mean.abs().max()) != 0.0:
        raise AssertionError("example 04's prior mean is not zero")
    tol = FEM_TOL["forward"] * kappa * float(torch.finfo(torch.float64).eps)
    dist = float((post.mean - xp).abs().max() / xp.abs().max())
    rk, rp = relative_residual(post.Q, post.mean, b), relative_residual(post.Q, xp, b)
    ok = dist <= tol and rk <= FEM_TOL["residual"] and rp <= FEM_TOL["residual"]
    bad += [] if ok else ["posterior mean vs plain"]
    log(f"    posterior mean, kernel path vs the plain versions of the {kind} backend on the card ({plain_s:.2f} s): "
        f"max rel {dist:.3e} (tol {tol:.2e}: {FEM_TOL['forward']:g} κ·ε at the equilibrated condition κ "
        f"{kappa:.3e}, by the plain factor); relative residuals kernel / plain {rk:.2e} / {rp:.2e} (tol {FEM_TOL['residual']:.0e}): "
        f"{'ok' if ok else 'MISSED'}")
    return bad


def post_qeps(prec, dev):
    """Example 04's observation precision, a diagonal SparseMatrix on `dev`."""
    from tpu_gmrf_torch.sparse import SparseMatrix, diag_pattern

    return SparseMatrix(torch.tensor(prec, dtype=torch.float64, device=dev), diag_pattern(len(prec)))


def draw_moments(draws, mean, std) -> tuple:
    """Per-node z of the draws' mean and χ² of their variance against the posterior's; the largest |z| and the
    χ² range against their Bonferroni limits at FEM_DRAW_LEVEL over all nodes."""
    from scipy.stats import chi2, norm

    k = draws.shape[0]
    z = (draws.mean(0) - mean) / (std / np.sqrt(k))
    c = (k - 1) * draws.var(0) / std.square()
    m = z.numel()
    zlim = float(norm.isf(FEM_DRAW_LEVEL / (4 * m)))
    lo, hi = float(chi2.ppf(FEM_DRAW_LEVEL / (4 * m), k - 1)), float(chi2.isf(FEM_DRAW_LEVEL / (4 * m), k - 1))
    zmax, cmin, cmax = float(z.abs().max()), float(c.min()), float(c.max())
    return zmax <= zlim and lo <= cmin and cmax <= hi, (
        f"draws: max |z| of the means {zmax:.2f} (limit {zlim:.2f}), (k-1)s²/σ² in [{cmin:.2f}, {cmax:.2f}] "
        f"(limits [{lo:.2f}, {hi:.2f}]; {m} nodes, Bonferroni at {FEM_DRAW_LEVEL:g})")


def st2d_cell(dn_model, nt: int, dev, card, counts: dict) -> list:
    """(b): the advection-diffusion space-time path at g=16 (ns=450) over nt steps, f64."""
    from unittest import mock

    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.fem import AdvectionDiffusionSPDE, SpatiotemporalGMRF
    from tpu_gmrf_torch.solvers import base as solver_base

    disc, ns = dn_model.disc, dn_model.n
    spde = AdvectionDiffusionSPDE(disc, **ST_SPDE)
    ts = np.linspace(0.0, 1.0, nt)
    steps = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            steps[name] = steps.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    def step(name, fn):
        return timed(name, fn)()

    kernels.reset_launches()
    # ---- the 2-D space-time path ----
    with mock.patch.object(AdvectionDiffusionSPDE, "_assemble", timed("assembly (host and K5)",
                                                                        AdvectionDiffusionSPDE._assemble)), \
            mock.patch.object(solver_base, "_large_sparse_kind", timed("SolverSpec() choice",
                                                                      solver_base._large_sparse_kind)):
        X = step("discretize", lambda: spde.discretize(ts))
    gen = torch.Generator(device=dev).manual_seed(ST_SEED)
    x_true = step("one prior draw", lambda: X.time_rands(gen))
    idx = (np.arange(0, nt, ST_OBS_EVERY)[:, None] * ns + np.arange(ns)[None]).ravel()
    y = torch.poisson(torch.exp(x_true.reshape(-1)[torch.as_tensor(idx, device=dev)]), generator=gen)
    lik = tg.ExponentialFamily("poisson", indices=idx)(y)
    post = step("gaussian_approximation", lambda: tg.gaussian_approximation(X.gmrf, lik))
    P = SpatiotemporalGMRF(post, nt, disc, ts)
    means = step("time_means", P.time_means)
    stds = step("time_stds", P.time_stds)
    draws = step(f"{ST_DRAWS} time_rands", lambda: P.time_rands(gen, (ST_DRAWS,)))
    got = kernels.launches()
    # ---- end of the 2-D space-time path ----
    kind = tg.SolverSpec().resolve(X.Q.pattern).kind
    launched(got, FEM_BASE_KERNELS + BACKEND_KERNELS[kind] + SELINV_KERNELS + ("dense_chol",), "2-D space-time")
    counts.update({k: counts.get(k, 0) + v for k, v in got.items()})
    log(f"  (b) 2-D advection-diffusion: ns={ns}, Nt={nt}, n={X.n}, nnz(Q)={X.Q.nnz}, {len(idx)} Poisson counts "
        f"(every {ST_OBS_EVERY}th step, total {int(y.sum())}); SolverSpec() -> {kind} for the joint and the posterior; "
        f"steps on the host clock: " + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items()) + f"; on {card}")
    log(f"    launches: { {k: v for k, v in got.items() if v} }")
    bad = []
    # the joint Q against its assembly on CPU tensors (the plain versions)
    tg.set_default_device("cpu")
    try:
        t0 = time.perf_counter()
        _, Qh = spde._assemble(ts)
        cpu_s = time.perf_counter() - t0
    finally:
        tg.set_default_device(dev)
    same = np.array_equal(Qh.pattern.rows, X.Q.pattern.rows) and np.array_equal(Qh.pattern.cols, X.Q.pattern.cols)
    qd = float((X.Q.data.cpu() - Qh.data).abs().max() / Qh.data.abs().max())
    ok = same and qd <= FEM_TOL["Q"]
    bad += [] if ok else ["joint Q"]
    log(f"    joint Q, kernel path vs CPU tensors ({cpu_s:.2f} s of host): same pattern {same}, max rel {qd:.3e} (tol "
        f"{FEM_TOL['Q']:.0e}): {'ok' if ok else 'MISSED'}")
    # the Newton mode against the Laplace approximation on the plain versions (card); κ by the plain factor
    t0 = time.perf_counter()
    with plain_direct():
        plain_post = tg.gaussian_approximation(X.gmrf, lik)
        sp_ = plain_post.std().reshape(nt, ns)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        kappa = equilibrated_condition(plain_post.Q, plain_post.factor)
    fwd = FEM_TOL["forward"] * kappa * float(torch.finfo(torch.float64).eps)
    for label, got_, ref_, floor in (("Newton mode", post.mean, plain_post.mean, FEM_TOL["mode"]),
                                     ("time_stds", stds, sp_, FEM_TOL["std"])):
        dist, tol = float((got_ - ref_).abs().max() / ref_.abs().max()), max(floor, fwd)
        bad += [] if dist <= tol else [label]
        log(f"    {label}, kernel path vs the plain versions of the {kind} backend on the card: max rel {dist:.3e} "
            f"(tol {tol:.2e}: the larger of {floor:.0e} and {FEM_TOL['forward']:g} κ·ε, κ {kappa:.3e}): "
            f"{'ok' if dist <= tol else 'MISSED'}")
    log(f"    (the plain path: the Laplace approximation and its stds in {plain_s:.2f} s)")
    ok, line = draw_moments(draws.double(), means, stds)
    bad += [] if ok else ["draws' moments"]
    log(f"    {line}: {'ok' if ok else 'MISSED'}")
    finite = bool(torch.isfinite(means).all() and torch.isfinite(stds).all() and torch.isfinite(draws).all())
    asserted(f"finite means, stds and draws of shapes {tuple(means.shape)}, {tuple(stds.shape)}, "
             f"{tuple(draws.shape)}", finite and tuple(draws.shape) == (ST_DRAWS, nt, ns), bad)
    return bad


def run_ex11(dev) -> dict:
    """Example 11 as written, float64, dense: the values its assertions and literals read."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.fem import AdvectionDiffusionSPDE, FEMDiscretization, MaternSPDE, interval_mesh

    n = 51
    disc = FEMDiscretization(interval_mesh(-1.0, 1.0, n))
    dense = tg.SolverSpec(kind="dense")
    kappa = torch.tensor(np.sqrt(8 * 1.5) / 0.5, dtype=torch.float64, device=dev)
    neumann = MaternSPDE(disc, smoothness=1, variance=0.3).discretize(kappa=kappa, solver=dense)
    v = neumann.var().cpu().numpy()
    dirichlet = MaternSPDE(disc, smoothness=1, variance=0.3, bc="dirichlet", boundary_noise=1e-4).discretize(
        kappa=kappa, solver=dense)
    s = dirichlet.std().cpu().numpy()
    A = torch.zeros((1, n), dtype=torch.float64, device=dev)
    A[0, 0], A[0, n - 1] = 1.0, -1.0
    periodic = tg.ConstrainedGMRF.create(neumann, A, torch.zeros(1, dtype=torch.float64, device=dev))
    xs = periodic.sample(torch.Generator(device=dev).manual_seed(0), (32,)).cpu().numpy()
    vp = periodic.var().cpu().numpy()
    spde = AdvectionDiffusionSPDE(disc, gamma=[-0.6], H=np.array([[0.1]]), tau=0.1, alpha=1, kappa=1.0, c=1.0,
                                  bc="dirichlet", constraint_noise=1e-4)
    stds = spde.discretize(np.linspace(0, 1, 8), solver=dense).time_stds().cpu().numpy()
    return {"Neumann var[0]": float(v[0]), "Neumann var[mid]": float(v[n // 2]), "Dirichlet std[0, -1]": s[[0, -1]],
            "Dirichlet std[mid]": float(s[n // 2]), "periodic gap": float(np.abs(xs[:, 0] - xs[:, -1]).max()),
            "periodic var ends": (float(vp[0]), float(vp[-1])), "AD-SPDE std[4, 0]": float(stds[4, 0]),
            "AD-SPDE std[4, mid]": float(stds[4, n // 2])}


def run_ex14(dev) -> dict:
    """Example 14 as written on icosphere(3), float64, supernodal, and solve_refined against the plain solve."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.fem import FEMDiscretization, MaternSPDE, icosphere

    mesh = icosphere(3)
    disc = FEMDiscretization(mesh)
    kappa = torch.tensor(np.sqrt(8 * 1.0) / 1.0, dtype=torch.float64, device=dev)
    prior = MaternSPDE(disc, smoothness=0, variance=1.0).discretize(kappa=kappa,
                                                                   solver=tg.SolverSpec(kind="supernodal"))
    v = prior.var().cpu().numpy()
    north = int(np.argmax(mesh.vertices[:, 2]))
    e = torch.zeros(len(v), dtype=prior.dtype, device=dev)
    e[north] = 1.0
    col = prior.factor.solve(e).cpu().numpy()
    corr = col / np.sqrt(v * v[north])
    geo = np.arccos(np.clip(mesh.vertices @ mesh.vertices[north], -1, 1))
    bins = np.digitize(geo, np.linspace(0, np.pi, 8))
    decay = [float(corr[bins == b].mean()) for b in range(1, 5)]
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(40, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    A = disc.evaluation_matrix(pts)
    yv = np.sin(2 * pts[:, 2]) + 0.5 * pts[:, 0]
    post = tg.linear_condition(prior, yv, Q_eps=400.0, A=A)
    fit = A.matvec(post.mean).cpu().numpy()
    vpost = post.var().cpu().numpy()
    b = torch.tensor(np.random.default_rng(14).normal(size=len(v)), dtype=torch.float64, device=dev)
    refined = prior.factor.solve_refined(prior.Q, b)
    plain = plain_factorize(prior.Q).solve(b)
    return {"n": mesh.n_vertices, "triangles": mesh.n_elements, "median var": float(np.median(v)),
            "near-pole corr": float(corr[geo < 0.3].mean()), "antipodal corr": float(corr[geo > np.pi - 0.5].mean()),
            "decay": decay, "fit error": float(np.abs(fit - yv).max()), "median var post": float(np.median(vpost)),
            "refined vs plain": float((refined - plain).abs().max() / plain.abs().max())}


def run_ex15(dev) -> dict:
    """Example 15 as written (float32 as the example runs): test accuracy and the probability surface."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.fem.obs_models import PointEvaluationObsModel

    rng = np.random.default_rng(42)
    n_pts = 580
    X = rng.uniform(0, 1, size=(n_pts, 2))
    logit = 5.0 * np.sin(4.0 * X[:, 0]) * np.cos(3.0 * X[:, 1]) + 3.0 * (X[:, 1] - 0.5)
    y_all = (rng.uniform(size=n_pts) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    perm = rng.permutation(n_pts)
    split = int(round(0.8 * n_pts))
    tr, te = perm[:split], perm[split:]
    latent = tg.MaternModel(X, smoothness=1)
    u = latent(tau=1.0, range=0.2)
    lik = PointEvaluationObsModel(latent.disc, X[tr], tg.ExponentialFamily("bernoulli"))(y_all[tr])
    post = tg.gaussian_approximation(u, lik)
    obs_test = PointEvaluationObsModel(latent.disc, X[te], tg.ExponentialFamily("bernoulli"))
    p_test = tg.conditional_distribution(obs_test, post.mean).mean().cpu().numpy()
    acc = float(np.mean((p_test >= 0.5) == (y_all[te] > 0.5)))
    gx, gy = np.meshgrid(np.linspace(0, 1, 100), np.linspace(0, 1, 100))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    obs_grid = PointEvaluationObsModel(latent.disc, grid, tg.ExponentialFamily("bernoulli"))
    probs = tg.conditional_distribution(obs_grid, post.mean).mean().cpu().numpy()
    return {"n": latent.n, "dtype": str(post.dtype), "accuracy": acc, "probs": probs}


def example_cell(label, run, kernels_path, dev, counts: dict):
    from tpu_gmrf_torch import kernels

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(dev)
    torch.cuda.synchronize()
    got = kernels.launches()
    secs = time.perf_counter() - t0
    launched(got, kernels_path, label)
    counts.update({k: counts.get(k, 0) + v for k, v in got.items()})
    return out, secs


def fem_path(dn_model, dev, card):
    """Phase 26: examples 04, 11, 14 and 15 and the 2-D space-time path; the kernels counted from zero for each
    cell and required to have launched there."""
    counts, bad = {}, []
    bad += ex04_cell(dev, card, counts)
    bad += st2d_cell(dn_model, ST_NT, dev, card, counts)
    v, secs = example_cell("example 11", run_ex11, ("dense_chol", "dense_trsv", "dense_selinv", "gather_segsum"),
                           dev, counts)
    log(f"  (c) example 11 (dense, f64) in {secs:.2f} s on {card}:")
    asserted(f"Neumann var[0] {v['Neumann var[0]']:.3f} > 1.5 var[mid]",
             v["Neumann var[0]"] > 1.5 * v["Neumann var[mid]"], bad)
    asserted(f"Dirichlet boundary std {v['Dirichlet std[0, -1]'].tolist()} within 1e-3 of 1e-4",
             bool(np.allclose(v["Dirichlet std[0, -1]"], 1e-4, rtol=1e-3)), bad)
    asserted(f"periodic gap over 32 samples {v['periodic gap']:.2e} < 1e-5; end variances "
             f"{v['periodic var ends'][0]:.6f} / {v['periodic var ends'][1]:.6f} within 1e-6",
             v["periodic gap"] < 1e-5 and abs(v["periodic var ends"][0] - v["periodic var ends"][1])
             <= 1e-6 * abs(v["periodic var ends"][1]), bad)
    asserted(f"AD-SPDE std[4, 0] {v['AD-SPDE std[4, 0]']:.2e} < 1e-3 < std[4, mid]",
             v["AD-SPDE std[4, 0]"] < 1e-3 < v["AD-SPDE std[4, mid]"], bad)
    for key, (gold, lim) in EX11_GOLD.items():
        held(key, v[key], gold, lim, bad)
    v, secs = example_cell("example 14", run_ex14, ("csr_spmv", "gather_segsum") + BACKEND_KERNELS["supernodal"]
                           + SELINV_KERNELS, dev, counts)
    log(f"  (d) example 14 (icosphere(3): {v['n']} vertices, {v['triangles']} triangles; supernodal, f64) in "
        f"{secs:.2f} s on {card}:")
    asserted(f"antipodal corr {v['antipodal corr']:.6f} within 0.02 of 0", abs(v["antipodal corr"]) < 0.02, bad)
    asserted(f"binned correlation decreasing {[round(x, 4) for x in v['decay']]}",
             all(a > b for a, b in zip(v["decay"], v["decay"][1:])), bad)
    asserted(f"posterior interpolation error {v['fit error']:.3f} < 0.25", v["fit error"] < 0.25, bad)
    asserted(f"posterior median var {v['median var post']:.4f} below the prior's", v["median var post"]
             < v["median var"], bad)
    for key, (gold, lim) in EX14_GOLD.items():
        held(key, v[key], gold, lim, bad)
    asserted(f"solve_refined vs the plain solve on the card: max rel {v['refined vs plain']:.3e} (tol "
             f"{FEM_TOL['refined']:.0e})", v["refined vs plain"] <= FEM_TOL["refined"], bad)
    v, secs = example_cell("example 15", run_ex15, ("csr_spmv", "dense_chol", "dense_trsv"), dev, counts)
    log(f"  (e) example 15 (n={v['n']}, {v['dtype']}) in {secs:.2f} s on {card}:")
    asserted(f"test accuracy {v['accuracy']:.2%} > 60%", v["accuracy"] > 0.6, bad)
    asserted("probability surface in [0, 1] on the 100x100 grid",
             bool(np.all((v["probs"] >= 0) & (v["probs"] <= 1))), bad)
    if bad:
        raise AssertionError(f"phase 26 failed: {bad}")
    return counts


# ---- phase 27: samplers breadth and chains over a mesh ----------------------------------------------------------

# (a) the flagship's width (bench.py:445-504: AR1(500), Poisson, the flagship's ParamSpec, max_iter 25, f32), with
# example 12's split of the log-density for SMC (log_prior = −½ z·z, log_lik = ld + ½ z·z)
SMC_FLAGSHIP = dict(particles=256, num_move_steps=2, hmc_num_steps=4, step_size=0.2)
ADVI_FLAGSHIP = dict(num_elbo_samples=256, num_steps=50)
MESH_FLAGSHIP = dict(chains=256, warmup=4, samples=4, depth=4, hmc_steps=8)
CKPT_FLAGSHIP = dict(warmup=4, chunk=2, first=4, then=8)
# SMC's first stage and ADVI's first gradient at fixed noise, against the f64 plain path on CPU tensors: f64 on
# the kernels as the slice's f64 bounds; f32 on the kernels within 1e-2 (λ₁, the evidence's increment: the
# bisection moves with the f32 log-likelihood's 1e-4) and SLICE_TOL's f32 gradient bound
SAMPLER_TOL = {"f64": 1e-8, "f64_grad": 1e-6, "f32": 1e-2, "f32_grad": 5e-3, "car": 1e-6}
# (b) example 12 parts 1-2 as written (examples/12_multichip_sharding.py:64-105), 2 chains and 32 particles a card;
# part 1's draws cut from 100 + 100 to 50 + 50 to keep the phase near 120 s (49.2 s uncut on the H100)
EX12_RUN = dict(n=64, chains=2, warmup=50, samples=50, particles=32)
# (c) example 07 as written (examples/07_autodiff_mcmc.py): CAR on N=21, 4 chains, 300 + 500 draws, max_depth 8
EX07_RUN = dict(N=21, chains=4, warmup=300, samples=500, depth=8, truth=dict(rho=0.85, sigma=0.01))
EX07_GOLDEN = 24.138412  # tools/golden_values.py:224, on the JAX package's draw: printed, not held
DENSE_KERNELS = ("dense_chol", "dense_trsv", "dense_selinv")
DRYRUN_KERNELS = FLAGSHIP_KERNELS + ("fct_init", "sn_panel", "bt_factor_blocks", "bt_trsv_blocks", "spike_reduced")


def tempered_split(ld):
    """Example 12's (log_prior, log_lik) for SMC from a log-density on (log τ, atanh ρ)."""
    def log_prior(z):
        return -0.5 * (z * z).sum(-1)

    def log_lik(z):
        return ld(z) + 0.5 * (z * z).sum(-1)

    return log_prior, log_lik


def synced(fn):
    """(fn(), its wall seconds, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_result(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def flagship_samplers(mesh, dev, card) -> dict:
    """(a): run_smc, run_advi, run_nuts and run_hmc over the mesh against the same calls without it, and
    run_nuts_checkpointed interrupted and resumed against an uninterrupted run, on the flagship in f32."""
    import tempfile

    import tpu_gmrf_torch as tg

    ld = logdensity(flagship_y())
    log_prior, log_lik = tempered_split(ld)
    f32 = dict(dtype=torch.float32, device=dev)
    smc_init = torch.tensor(0.5 * np.random.default_rng(7).normal(size=(SMC_FLAGSHIP["particles"], 2)), **f32)
    moves = {k: SMC_FLAGSHIP[k] for k in ("num_move_steps", "hmc_num_steps", "step_size")}
    cfg, ck = MESH_FLAGSHIP, CKPT_FLAGSHIP
    z0 = torch.zeros(cfg["chains"], 2, **f32)
    out = {}

    def run():
        out["smc"], out["smc_s"] = synced(lambda: tg.run_smc(log_prior, log_lik, 21, smc_init, mesh=mesh, **moves))
        out["advi"], out["advi_s"] = synced(lambda: tg.run_advi(ld, 22, torch.zeros(2, **f32), mesh=mesh,
                                                                **ADVI_FLAGSHIP))
        for name, fn in (("run_nuts", lambda m: tg.run_nuts(ld, 23, z0, cfg["warmup"], cfg["samples"], cfg["depth"],
                                                              mesh=m)),
                         ("run_hmc", lambda m: tg.run_hmc(ld, 24, z0, cfg["warmup"], cfg["samples"], cfg["hmc_steps"],
                                                            mesh=m))):
            out[name], out[name + "_s"] = synced(lambda: fn(mesh))
            out[name + " no mesh"], out[name + " no mesh_s"] = synced(lambda: fn(None))
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(num_warmup=ck["warmup"], chunk_size=ck["chunk"], max_depth=cfg["depth"])
            (first, _), out["ckpt_first_s"] = synced(lambda: tg.run_nuts_checkpointed(
                ld, 25, z0, os.path.join(tmp, "a"), num_samples=ck["first"], **kw))
            (resumed, _), out["ckpt_resume_s"] = synced(lambda: tg.run_nuts_checkpointed(
                ld, 25, z0, os.path.join(tmp, "a"), num_samples=ck["then"], **kw))
            (whole, _), out["ckpt_whole_s"] = synced(lambda: tg.run_nuts_checkpointed(
                ld, 25, z0, os.path.join(tmp, "b"), num_samples=ck["then"], **kw))
        out["ckpt"] = (first, resumed, whole)

    counts = {}
    _, secs = example_cell("phase 27(a) flagship samplers", lambda _: run(), FLAGSHIP_KERNELS, dev, counts)
    bad = []
    smc = out["smc"]
    k = smc.num_stages
    log(f"  (a) run_smc, {SMC_FLAGSHIP['particles']} particles, {moves}: {k} stages, λ "
        f"{[round(x, 6) for x in smc.lambdas[:k].tolist()]}, log evidence {float(smc.log_evidence):.6f}; "
        f"{out['smc_s']:.2f} s, {out['smc_s'] / max(k, 1):.3f} s per stage (host clock) on {card}")
    asserted("SMC particles finite, log evidence finite, λ reaches 1",
             bool(torch.isfinite(smc.particles).all()) and bool(torch.isfinite(smc.log_evidence))
             and float(smc.lambdas[k - 1]) >= 1.0, bad)
    advi = out["advi"]
    log(f"  (a) run_advi, {ADVI_FLAGSHIP}: ELBO {float(advi.elbo_trace[0]):.4f} -> {float(advi.elbo_trace[-1]):.4f}, "
        f"mean {[round(x, 4) for x in advi.mean.tolist()]}, std {[round(x, 4) for x in advi.log_std.exp().tolist()]}; "
        f"{out['advi_s']:.2f} s, {out['advi_s'] / ADVI_FLAGSHIP['num_steps'] * 1e3:.1f} ms per step on {card}")
    asserted("ADVI trace finite", bool(torch.isfinite(advi.elbo_trace).all()), bad)
    for name in ("run_nuts", "run_hmc"):
        a, b = out[name], out[name + " no mesh"]
        log(f"  (a) {name} over the one-rank mesh: {nuts_line(a, out[name + '_s'])}; without the mesh "
            f"{out[name + ' no mesh_s']:.1f} s; on {card}")
        asserted(f"{name} over the mesh equal to the call without it (samples, depths, step sizes, every field)",
                 same_result(a, b), bad)
    first, resumed, whole = out["ckpt"]
    log(f"  (a) run_nuts_checkpointed, chunks of {ck['chunk']}: {ck['first']} draws {out['ckpt_first_s']:.1f} s "
        f"(warmup {ck['warmup']} included), resumed to {ck['then']} {out['ckpt_resume_s']:.1f} s, uninterrupted "
        f"{ck['then']} {out['ckpt_whole_s']:.1f} s")
    asserted("the resumed run keeps the first draws and equals the uninterrupted one",
             torch.equal(resumed[:, :ck["first"]], first) and torch.equal(resumed, whole), bad)
    bad += flagship_sampler_pieces(ld, smc_init, moves, smc, dev)
    log(f"  (a) seconds on the counted path {secs:.1f}")
    if bad:
        raise AssertionError(f"phase 27 (a) failed: {bad}")
    return counts


def flagship_sampler_pieces(ld, smc_init, moves, smc, dev) -> list:
    """SMC's first stage (λ₁, the evidence's increment) and ADVI's first gradient at its first noise, on the
    kernels in f32 and f64 against the f64 plain path on CPU tensors."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers.vi import elbo_and_grad

    bad = []
    y = flagship_y()
    first = {}
    for label, dtype, device in (("f32", torch.float32, dev), ("f64", torch.float64, dev),
                                 ("plain", torch.float64, torch.device("cpu"))):
        ld_ = ld if dtype == torch.float32 else logdensity(y.astype(np.float64))
        prior, lik = tempered_split(ld_)
        stage = tg.run_smc(prior, lik, 21, smc_init.to(device, dtype), max_stages=1,
                           **dict(moves, num_move_steps=0))
        eps = torch.randn((ADVI_FLAGSHIP["num_elbo_samples"], 2), generator=torch.Generator(device=dev).manual_seed(22),
                          dtype=torch.float32, device=dev)
        x0 = torch.zeros(2, dtype=dtype, device=device)
        elbo, gm, gs = elbo_and_grad(ld_, x0, torch.full_like(x0, -1.0), eps.to(device, dtype))
        first[label] = (float(stage.lambdas[0]), float(stage.log_evidence), float(elbo), torch.cat([gm, gs]).cpu().double())
    p = first["plain"]
    for label in ("f64", "f32"):
        lam, inc, elbo, g = first[label]
        errs = (abs(lam - p[0]) / abs(p[0]), abs(inc - p[1]) / abs(p[1]), abs(elbo - p[2]) / abs(p[2]),
                float((g - p[3]).norm() / p[3].norm()))
        tol, gtol = SAMPLER_TOL[label], SAMPLER_TOL[label + "_grad"]
        asserted(f"{label} on the kernels vs the f64 plain path: SMC λ₁ {lam:.9f} / {p[0]:.9f} rel {errs[0]:.2e}, "
                 f"increment {inc:.6f} / {p[1]:.6f} rel {errs[1]:.2e} (tol {tol:.0e}); ADVI's first ELBO rel "
                 f"{errs[2]:.2e} (tol {tol:.0e}), gradient {g.tolist()} rel {errs[3]:.2e} (tol {gtol:.0e})",
                 max(errs[:3]) <= tol and errs[3] <= gtol, bad)
    asserted(f"the f32 first-stage λ₁ {first['f32'][0]!r} equals the main run's {float(smc.lambdas[0])!r}",
             first["f32"][0] == float(smc.lambdas[0]), bad)
    return bad


def ex12_logdensity(dev):
    """Example 12's flagship posterior at n=64: AR1, Poisson(2) counts from seed 0, the flagship's ParamSpec, f32."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import make_logdensity

    n = EX12_RUN["n"]
    y = np.random.default_rng(0).poisson(2.0, size=n).astype(np.float32)
    model, obs = tg.AR1Model(n), tg.ExponentialFamily("poisson")
    return make_logdensity(lambda th: tg.laplace_marginal(model, obs, torch.tensor(y, device=dev), th),
                           flagship_spec())


def example12_parts(mesh, dev, card, counts: dict) -> list:
    """(b): example 12 parts 1-2 on the mesh: chain-parallel NUTS and particle-parallel SMC, its assertion."""
    import tpu_gmrf_torch as tg

    cfg = EX12_RUN
    ld = ex12_logdensity(dev)
    log_prior, log_lik = tempered_split(ld)
    init_p = torch.tensor(0.5 * np.random.default_rng(1).normal(size=(cfg["particles"], 2)), dtype=torch.float32,
                          device=dev)

    def run():
        res = tg.run_nuts(ld, 0, torch.zeros(cfg["chains"], 2, dtype=torch.float32, device=dev),
                          num_warmup=cfg["warmup"], num_samples=cfg["samples"], mesh=mesh)
        smc = tg.run_smc(log_prior, log_lik, 2, init_p, num_move_steps=2, hmc_num_steps=4, step_size=0.2, mesh=mesh)
        return res, smc

    (res, smc), secs = example_cell("phase 27(b) example 12", lambda _: run(), FLAGSHIP_KERNELS, dev, counts)
    tau_post = torch.exp(res.samples[..., 0]).double()
    tau_smc = torch.exp(smc.particles[:, 0]).double()
    log(f"  (b) example 12 part 1: NUTS {cfg['chains']} chains x {cfg['samples']} draws (+{cfg['warmup']} warmup), "
        f"n={cfg['n']}: τ {float(tau_post.mean()):.3f} ± {float(tau_post.std(unbiased=False)):.3f}, depth mean "
        f"{res.depth.float().mean():.2f}; part 2: SMC {cfg['particles']} particles, {smc.num_stages} stages, τ mean "
        f"{float(tau_smc.mean()):.3f}, log evidence {float(smc.log_evidence):.4f}; {secs:.1f} s on {card}")
    bad = []
    asserted("samples finite", bool(torch.isfinite(res.samples).all()), bad)
    asserted("|SMC τ mean − NUTS τ mean| < NUTS τ std",
             abs(float(tau_smc.mean() - tau_post.mean())) < float(tau_post.std(unbiased=False)), bad)
    return bad


def ex07_weights():
    """Example 07's 21-point chain graph with 1/|k| weights at lags 1 and 2."""
    import scipy.sparse as sp

    N = EX07_RUN["N"]
    rows, cols, vals = [], [], []
    for i in range(N):
        for k in (-2, -1, 1, 2):
            if 0 <= i + k < N:
                rows.append(i)
                cols.append(i + k)
                vals.append(1.0 / abs(k))
    return sp.csr_matrix((vals, (rows, cols)), shape=(N, N))


def example07(dev, card, counts: dict) -> list:
    """(c): example 07 as written on the card: the CAR draw, NUTS over (ρ, σ) auto -> dense, the 95% intervals;
    the logpdf at the truth on the port's draw against a NumPy f64 dense oracle."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import LogitTransform, ParamSpec, make_logdensity

    cfg, W = EX07_RUN, ex07_weights()
    truth = cfg["truth"]
    spec = ParamSpec(rho=(LogitTransform(0.5, 0.99), lambda r: 0.0), sigma=(LogitTransform(0.001, 0.1), lambda s: 0.0))

    def run():
        true_car = tg.generate_car_model(W, torch.tensor(truth["rho"], device=dev), sigma=truth["sigma"])
        y = true_car.sample(torch.Generator(device=dev).manual_seed(123))
        ld = make_logdensity(lambda th: tg.generate_car_model(W, th["rho"], sigma=th["sigma"]).logpdf(y), spec)
        res = tg.run_nuts(ld, 456, torch.zeros(cfg["chains"], 2, dtype=torch.float32, device=dev),
                          num_warmup=cfg["warmup"], num_samples=cfg["samples"], max_depth=cfg["depth"])
        return y, res

    (y, res), secs = example_cell("phase 27(c) example 07", lambda _: run(), DENSE_KERNELS, dev, counts)
    bad = []
    Q = tg.CARModel(W).precision(torch.tensor(truth["rho"], dtype=torch.float64, device=dev), truth["sigma"])
    log(f"  (c) example 07: CAR N={cfg['N']}, {cfg['chains']} chains x {cfg['samples']} draws (+{cfg['warmup']} "
        f"warmup), max_depth {cfg['depth']}, inner solver auto -> {tg.SolverSpec().resolve(Q.pattern).kind}: "
        f"{nuts_line(res, secs)} on {card}")
    draws = spec.constrain(res.samples.double())
    for name in ("rho", "sigma"):
        s = draws[name].flatten().cpu().numpy()
        lo, hi = np.quantile(s, [0.025, 0.975])
        asserted(f"{name}: posterior mean {s.mean():.4f} ± {s.std():.4f}, 95% interval [{lo:.4f}, {hi:.4f}] holds "
                 f"the truth {truth[name]}", lo <= truth[name] <= hi, bad)
    y64 = y.double()
    ll = float(tg.generate_car_model(W, torch.tensor(truth["rho"], dtype=torch.float64, device=dev),
                                     sigma=truth["sigma"]).logpdf(y64))
    Wd, yd = W.toarray(), y64.cpu().numpy()
    Qd = (np.diag(Wd.sum(1)) - truth["rho"] * Wd) / truth["sigma"]
    oracle = 0.5 * np.linalg.slogdet(Qd)[1] - 0.5 * yd @ Qd @ yd - 0.5 * cfg["N"] * np.log(2 * np.pi)
    asserted(f"logpdf at the truth on the port's draw {ll:.6f} vs the NumPy f64 dense oracle {oracle:.6f}, rel "
             f"{abs(ll - oracle) / abs(oracle):.2e} (tol {SAMPLER_TOL['car']:.0e}); the golden {EX07_GOLDEN} is on "
             f"the JAX package's draw (held by the CPU tests)", abs(ll - oracle) <= SAMPLER_TOL["car"] * abs(oracle), bad)
    return bad


def samplers_path(dev, card) -> dict:
    """Phase 27 on a one-rank NCCL DeviceMesh whose dimension is named "chains": (a) the flagship samplers,
    (b) example 12 parts 1-2, (c) example 07, (d) the dryrun_multichip twin; the kernels counted from zero for
    each part and required to have launched there."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_gmrf_torch.multichip import dryrun_multichip

    with socket.socket() as sock:  # a free port on this host for the one-rank process group
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("chains",))
        t0 = time.perf_counter()
        counts = flagship_samplers(mesh, dev, card)
        log(f"  (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bad = example12_parts(mesh, dev, card, counts)
        log(f"  (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bad += example07(dev, card, counts)
        log(f"  (c) {time.perf_counter() - t0:.1f} s")
        out, secs = example_cell("phase 27(d) dryrun_multichip", lambda _: dryrun_multichip(mesh), DRYRUN_KERNELS, dev,
                                 counts)
        log(f"  (d) dryrun_multichip twin on the one-rank mesh, seven parts: {secs:.1f} s; NUTS step accept "
            f"{float(out['step']['accept']):.3f}, run_nuts depth mean {out['nuts'].depth.float().mean():.2f}, SPIKE "
            f"logdet {float(out['spike']['logdet']):.6f}, SMC log evidence {float(out['smc'].log_evidence):.6f}, "
            f"ADVI last ELBO {float(out['advi'].elbo_trace[-1]):.6f}, supernodal logdet {float(out['supernodal']['single']):.4f}"
            f" / {float(out['supernodal']['mesh']):.4f}, run_hmc accept {out['hmc'].accept_prob.mean():.3f}; on {card}")
    finally:
        dist.destroy_process_group()
    if bad:
        raise AssertionError(f"phase 27 failed: {bad}")
    return counts


# ---- phase 28: the formula interface, shapefile contiguity and example 06 --------------------------------------

# (a) example 06's synthetic districts (examples/06_bym_disease_mapping.py:26-52) at nx = ny = FORMULA_GRID, N = 10,000,
# written as one .shp and read back; queen and rook W. (b) the disease map at that N: example 06's recipe at seed 7
# (the truth's centres rescaled to the 8 x 7 map's extent), each formula 20,002 unknowns (two fixed effects beside
# 20,000 random ones), Poisson with exposure E, FORMULA_CHAINS chains, f64: laplace_marginal's value and θ-gradient on
# the kernels against the plain path (CPU tensors) with SLICE_TOL's f64 bounds, as phase 20; every chain's mode on its
# constraint to FORMULA_MODE_TOL; at the example's θ the posterior mean, std and FORMULA_DRAWS draws, and the example's
# recovery checks. (c) example 06 as written (56 districts). (d) every term at tests/test_formula.py's sizes, plus AR1,
# RW2 and a Matérn term on 200 points, through gaussian_approximation on the kernels against the plain path: means and
# stds at FORMULA_TOL (the kernels add in another order; a constrained mode is fixed only to ~√eps by the line
# search, tests/test_torch_constrained_ga.py).
FORMULA_GRID, FORMULA_CHAINS, FORMULA_DRAWS, FORMULA_MODE_TOL = 100, 4, 400, 1e-10
FORMULA_TOL = {"free": 1e-8, "constrained": 1e-7}
FORMULA_BYM = ("y ~ 1 + aff + Besag(district, W) + IID(district)",
               {"tau_besag": [1.0, 2.0, 4.0, 8.0], "tau_iid": [16.0] * 4}, {"tau_besag": 4.0, "tau_iid": 16.0})
FORMULA_BYM2 = ("y ~ 1 + aff + BYM2(district, W)",
                {"tau_bym2": [1.0, 2.0, 4.0, 8.0], "phi_bym2": [0.2, 0.4, 0.6, 0.8]}, {"tau_bym2": 2.0, "phi_bym2": 0.4})
FORMULA_BASE_KERNELS = ("csr_spmv", "gather_segsum")
FORMULA_TERM_KERNELS = FORMULA_BASE_KERNELS + ("tridiag_factor", "tridiag_solve", "dense_chol", "dense_trsv")


def ex06_districts(nx: int = 8, ny: int = 7, seed: int = 0):
    """examples/06_bym_disease_mapping.py:26-52: a grid of quads with jittered interior vertices (shared between
    neighbours), as (polygons, centres)."""
    rng = np.random.default_rng(seed)
    VX, VY = np.meshgrid(np.arange(nx + 1, dtype=float), np.arange(ny + 1, dtype=float), indexing="ij")
    jit = 0.25 * rng.uniform(-1, 1, size=VX.shape + (2,))
    jit[0, :, :] = jit[-1, :, :] = 0.0
    jit[:, 0, :] = jit[:, -1, :] = 0.0
    VX, VY = VX + jit[..., 0], VY + jit[..., 1]
    polys = []
    for i in range(nx):
        for j in range(ny):
            corners = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1), (i, j)]
            polys.append([np.array([[VX[a, b], VY[a, b]] for a, b in corners])])
    centers = np.array([p[0][:-1].mean(axis=0) for p in polys])
    return polys, centers


def write_polygon_shapefile(path, polygons) -> None:
    """A minimal .shp of one-ring polygon records (tests/test_parity_layers.py:166-194, for any rings)."""
    body = []
    for k, (ring,) in enumerate(polygons):
        ring = np.asarray(ring, dtype="<f8")
        content = struct.pack("<i", 5) + struct.pack("<4d", *ring.min(0), *ring.max(0))
        content += struct.pack("<iii", 1, len(ring), 0) + ring.tobytes()  # one part of len(ring) points, at 0
        body.append(struct.pack(">ii", k + 1, len(content) // 2) + content)
    body = b"".join(body)
    header = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(">i", (100 + len(body)) // 2)
    header += struct.pack("<ii", 1000, 5) + struct.pack("<8d", 0, 0, 0, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(header + body)


def ex06_data(nx: int = 8, ny: int = 7):
    """Example 06's data (examples/06_bym_disease_mapping.py:55-74, seed 7), the truth's centres rescaled to the
    8 x 7 map's extent: (polygons, data, η_true)."""
    rng = np.random.default_rng(7)
    polys, centers = ex06_districts(nx, ny)
    n_d = len(polys)
    c = centers * np.array([8.0 / nx, 7.0 / ny])
    aff = rng.uniform(0.0, 0.3, size=n_d)
    u_true = 0.6 * np.sin(1.2 * c[:, 0]) * np.cos(0.9 * c[:, 1])
    v_true = 0.15 * rng.standard_normal(n_d)
    eta_true = -0.2 + 2.0 * aff + u_true + v_true
    E = rng.uniform(5.0, 80.0, size=n_d)
    y = rng.poisson(E * np.exp(eta_true)).astype(np.float64)
    return polys, {"y": y, "aff": aff, "E": E, "district": np.arange(n_d)}, eta_true


@contextlib.contextmanager
def default_on(device):
    """A context in which the port's default device is `device` (the plain path: FixedEffectsModel's ridge and a
    formula's design go there)."""
    import tpu_gmrf_torch as tg

    before = tg.default_device()
    tg.set_default_device(device)
    try:
        yield
    finally:
        tg.set_default_device(before)


def on_cpu(comps):
    """A formula's observation model with its design copied to CPU tensors."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.sparse import SparseMatrix

    return tg.LinearlyTransformedObservationModel(comps.obs_model.base_model,
                                                  SparseMatrix(comps.A.data.cpu(), comps.A.pattern))


def formula_vg(comps, obs, theta: dict, opts):
    """laplace_marginal (B,) and its θ-gradient (B, k) through a formula-built model."""
    import tpu_gmrf_torch as tg

    th = {k: v.detach().clone().requires_grad_() for k, v in theta.items()}
    v = tg.laplace_marginal(comps.combined_model, obs, comps.y, th, options=opts)
    v.sum().backward()
    return v.detach(), torch.stack([th[k].grad for k in comps.hyperparameters], -1)


def auto_costs(pattern) -> str:
    """The two costs SolverSpec()'s auto rule weighs on a large pattern (solvers/base.py::_large_sparse_kind); the
    plans are cached by then."""
    from tpu_gmrf_torch.solvers.banded import banded_plan
    from tpu_gmrf_torch.solvers.supernodal import supernodal_symbolic_summary

    bp, sm = banded_plan(pattern, None), supernodal_symbolic_summary(pattern)
    return (f"banded: blocks of {bp['s']}, n·s² = {float(bp['npad']) * float(bp['s']) ** 2:.4g}; supernodal: "
            f"4·flops + 2e7·buckets = {sm['flops'] * 4.0 + sm['nbuckets'] * 2.0e7:.4g} ({sm['nbuckets']} buckets)")


def geo_cell(card):
    """Phase 28(a): example 06's districts at N = 10,000 through a shapefile, queen and rook."""
    import tempfile

    import tpu_gmrf_torch as tg

    secs = {}
    t0 = time.perf_counter()
    polys, _ = ex06_districts(FORMULA_GRID, FORMULA_GRID)
    secs["polygons"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "districts.shp")
        t0 = time.perf_counter()
        write_polygon_shapefile(path, polys)
        secs["write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        read = tg.read_shapefile_polygons(path)
        secs["read"] = time.perf_counter() - t0
        W = {}
        for crit in ("queen", "rook"):
            t0 = time.perf_counter()
            W[crit] = tg.contiguity_adjacency(read, crit)
            secs[crit] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mem = {crit: tg.contiguity_adjacency(polys, crit) for crit in W}
    secs["in memory, both"] = time.perf_counter() - t0
    bad = []
    N = len(polys)
    interior = (FORMULA_GRID // 2) * FORMULA_GRID + FORMULA_GRID // 2  # district (50, 50)
    log(f"  (a) {N} districts written to one .shp and read back ({len(read)} polygons); host seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + f"; on {card}")
    for crit, want in (("queen", 8), ("rook", 4)):
        w = W[crit]
        asserted(f"{crit} W: {w.nnz} entries, symmetric", (abs(w - w.T)).nnz == 0 and w.shape == (N, N), bad)
        asserted(f"{crit} W from the file equals W from the polygons in memory",
                 (abs(w - mem[crit])).nnz == 0 and w.nnz == mem[crit].nnz, bad)
        asserted(f"{crit}: interior district {interior} has {w[interior].nnz} neighbours (want {want})",
                 w[interior].nnz == want, bad)
    return W["queen"], bad


def disease_map_cell(W, dev, card, counts: dict) -> list:
    """Phase 28(b): the BYM and BYM2 disease maps at N = 10,000 (20,002 unknowns each) on the card."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.formula import build_formula_components
    from tpu_gmrf_torch.inference.gaussian_approximation import _posterior_pair

    _, data, eta_true = ex06_data(FORMULA_GRID, FORMULA_GRID)
    opts = tg.GAOptions(max_iter=GA_MAX_ITER)
    bad = []
    for label, (formula, chains, one) in (("BYM", FORMULA_BYM), ("BYM2", FORMULA_BYM2)):
        t0 = time.perf_counter()
        comps = build_formula_components(formula, data, family="poisson", exposure="E", context={"W": W})
        build_s = time.perf_counter() - t0
        n = comps.A.shape[1]
        th = on(chains, torch.float64, dev)
        with torch.no_grad():  # the posterior's pattern, as the Newton loop forms it, and the backend auto picks
            prior = comps.combined_model(**th)
            lik = comps.obs_model(comps.y)
            pattern = _posterior_pair(prior.Q, lik.loghessian(torch.zeros_like(prior.mean))).pattern
        t0 = time.perf_counter()
        kind = tg.SolverSpec().resolve(pattern).kind
        choice_s = time.perf_counter() - t0
        prior_kind = tg.SolverSpec().resolve(prior.Q.pattern).kind
        path = FORMULA_BASE_KERNELS + BACKEND_KERNELS[kind] + (SELINV_KERNELS if kind != "dense" else ())
        kernels.reset_launches()
        # ---- the disease map's main path: value+grad twice, the modes, one θ's posterior, std and draws ----
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = formula_vg(comps, comps.obs_model, th, opts)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got2 = formula_vg(comps, comps.obs_model, th, opts)
        torch.cuda.synchronize()
        vg_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            prior = comps.combined_model(**th)
            modes = tg.gaussian_approximation(prior, comps.obs_model(comps.y), options=opts)
            resid = float((modes.mean @ prior.A.T - prior.e).abs().max())
            t0 = time.perf_counter()
            post = tg.gaussian_approximation(comps.combined_model(**on(one, torch.float64, dev)),
                                             comps.obs_model(comps.y), options=opts)
            mean, std = post.mean, post.std()
            draws = post.sample(torch.Generator(device=dev).manual_seed(0), (FORMULA_DRAWS,))
            p_exc = (comps.A.matvec(draws) > 0.0).double().mean(0)
            eta = comps.A.matvec(mean)
            torch.cuda.synchronize()
            post_s = time.perf_counter() - t0
        got_counts = kernels.launches()
        # ---- end of the disease map's main path ----
        launched(got_counts, path, f"phase 28(b) {label}")
        counts.update({k: counts.get(k, 0) + v for k, v in got_counts.items()})
        iters = verbose_iterations(lambda: tg.laplace_marginal(
            comps.combined_model, comps.obs_model, comps.y, th, options=dataclasses.replace(opts, verbose=True)))
        log(f"  (b) {label} `{formula}`: n={n} ({comps.meta['term_sizes']}), {FORMULA_CHAINS} chains, f64; built in "
            f"{build_s:.2f} s (host clock); SolverSpec() resolves the posterior (nnz {pattern.nnz}) to {kind} in "
            f"{choice_s:.2f} s of host ({auto_costs(pattern)}; the prior's pattern to {prior_kind}); value+grad {first_ms:.1f} ms first call, {vg_ms:.1f} ms second "
            f"(host clock); Newton iterations (slowest chain) {iters}; one θ's posterior, std and {FORMULA_DRAWS} draws "
            f"{post_s:.2f} s; launches {dict((k, v) for k, v in got_counts.items() if v)}; on {card}")
        if not bool((got[0] == got2[0]).all()):
            bad.append(f"{label}: two value+grads of the same θ differ")
        t0 = time.perf_counter()
        with default_on("cpu"):
            ref = formula_vg(comps, on_cpu(comps), on(chains, torch.float64, "cpu"), opts)
        log(f"    (the plain value+grad on CPU tensors took {time.perf_counter() - t0:.1f} s of host)")
        hold_f64(f"{label} N={W.shape[0]}", got, ref, FORMULA_CHAINS)
        asserted(f"{label} modes: max |A x* - e| {resid:.3e} <= {FORMULA_MODE_TOL:.0e}", resid <= FORMULA_MODE_TOL, bad)
        mean, std, eta, p_exc = (t.double().cpu().numpy() for t in (mean, std, eta, p_exc))
        b_aff, s_aff = mean[-1], std[-1]
        r = np.corrcoef(eta, eta_true)[0, 1]
        log(f"    at {one}: intercept {mean[-2]:.4f} ± {1.96 * std[-2]:.4f}, aff {b_aff:.4f} ± {1.96 * s_aff:.4f} "
            f"(truth -0.2, 2.0); corr(η̂, η_true) {r:.4f}; districts with P(RR > 1) > 0.8: {int((p_exc > 0.8).sum())}")
        asserted(f"{label} aff coefficient {b_aff:.4f} within 3·1.96·std + 0.5 of 2.0",
                 abs(b_aff - 2.0) < 3 * 1.96 * s_aff + 0.5, bad)
        asserted(f"{label} std finite", bool(np.isfinite(std).all()), bad)
        if label == "BYM":
            asserted(f"BYM corr(η̂, η_true) {r:.4f} > 0.9", r > 0.9, bad)
    return bad


def run_ex06(dev) -> dict:
    """examples/06_bym_disease_mapping.py as written (its θ as Python numbers), on `dev`."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.formula import build_formula_components

    polys, data, eta_true = ex06_data()
    W = tg.contiguity_adjacency(polys, criterion="queen")
    with default_on(dev):
        comp = build_formula_components("y ~ 1 + aff + Besag(district, W) + IID(district)", data, family="poisson",
                                        exposure="E", context={"W": W})
        post = tg.gaussian_approximation(comp.combined_model(tau_besag=4.0, tau_iid=16.0), comp.obs_model(comp.y))
        eta = comp.A.matvec(post.mean)
        samp = post.sample(torch.Generator(device=dev).manual_seed(0), (400,))
        p_exc = (comp.A.matvec(samp) > 0.0).double().mean(0)
        comp2 = build_formula_components("y ~ 1 + aff + BYM2(district, W)", data, family="poisson", exposure="E",
                                         context={"W": W})
        post2 = tg.gaussian_approximation(comp2.combined_model(tau_bym2=2.0, phi_bym2=0.4), comp2.obs_model(comp2.y))
        eta2 = comp2.A.matvec(post2.mean)
        mean, std = post.mean.cpu().numpy(), post.std().cpu().numpy()
    eta, eta2 = eta.cpu().numpy(), eta2.cpu().numpy()
    return {"n": comp.A.shape[1], "dtype": str(post.mean.dtype), "W edges": int(W.nnz // 2), "mean": mean, "std": std,
            "r": np.corrcoef(eta, eta_true)[0, 1], "r2": np.corrcoef(eta2, eta_true)[0, 1],
            "p_exc": int((p_exc.cpu().numpy() > 0.8).sum())}


def formula_term_cases():
    """name: (formula, data, family, build keywords, θ of the prior, θ of the likelihood); tests/test_formula.py's
    cases at its sizes (rng(42)), plus AR1, RW2 and a Matérn term on 200 points."""
    from tpu_gmrf_torch.formula import IID, RW1, Separable

    cases = {}
    rng = np.random.default_rng(42)
    group, t, x = rng.integers(0, 5, size=60), rng.integers(0, 10, size=60), rng.normal(size=60)
    cases["IID + RW1"] = ("y ~ 1 + x + IID(group) + RW1(time)",
                          {"y": rng.normal(size=60) + x * 0.5, "x": x, "group": group, "time": t}, "normal", {},
                          {"tau_iid": 1.0, "tau_rw1": 1.0}, {"sigma": 1.0})
    rng = np.random.default_rng(42)
    region, E = rng.integers(0, 16, size=48), rng.uniform(0.5, 2.0, size=48)
    cases["Besag + exposure"] = ("y ~ 1 + Besag(region, W)", {"y": rng.poisson(E * 1.5), "region": region, "E": E},
                                 "poisson", {"exposure": "E", "context": {"W": grid_adjacency(4, 4)}}, {"tau_besag": 1.0}, {})
    rng = np.random.default_rng(42)
    cases["BYM2"] = ("y ~ BYM2(region, W)", {"y": rng.poisson(2.0, size=27), "region": rng.integers(0, 9, size=27)},
                     "poisson", {"context": {"W": grid_adjacency(3, 3)}}, {"tau_bym2": 1.0, "phi_bym2": 0.5}, {})
    rng = np.random.default_rng(42)
    g, t = rng.integers(0, 3, size=40), rng.integers(0, 4, size=40)
    cases["Separable"] = ([Separable(RW1("t"), IID("g"))], {"y": rng.normal(size=40), "g": g, "t": t}, "normal", {},
                          {"tau_rw1_separable": 1.0, "tau_iid_separable": 2.0}, {"sigma": 1.0})
    rng = np.random.default_rng(42)
    group = rng.integers(0, 4, size=30)
    cases["IID (predict_cols)"] = ("y ~ IID(group)", {"y": rng.normal(size=30), "group": group}, "normal", {},
                                   {"tau_iid": 1.0}, {"sigma": 1.0})
    rng = np.random.default_rng(42)
    group, x = rng.integers(0, 4, size=30), rng.normal(size=30)
    cases["x + IID (predict_cols)"] = ("y ~ x + IID(group)", {"y": rng.normal(size=30), "group": group, "x": x},
                                       "normal", {}, {"tau_iid": 1.0}, {"sigma": 1.0})
    rng = np.random.default_rng(42)
    t = rng.integers(0, 12, size=40)
    cases["AR1"] = ("y ~ 1 + AR1(t)", {"y": rng.poisson(np.exp(0.3 * np.sin(t)), size=40), "t": t}, "poisson", {},
                    {"tau_ar1": 2.0, "rho_ar1": 0.6}, {})
    rng = np.random.default_rng(42)
    t = rng.integers(0, 30, size=90)
    cases["RW2"] = ("y ~ 1 + RW2(t)", {"y": np.sin(t / 5.0) + 0.2 * rng.normal(size=90), "t": t}, "normal", {},
                    {"tau_rw2": 4.0}, {"sigma": 0.2})
    rng = np.random.default_rng(42)
    px, py = rng.uniform(size=200), rng.uniform(size=200)
    cases["Matern"] = ("y ~ 1 + z + Matern(['px', 'py'], smoothness=1)",
                       {"y": np.sin(3 * px) * np.cos(2 * py) + 0.1 * rng.normal(size=200), "px": px, "py": py,
                        "z": rng.normal(size=200)}, "normal", {}, {"tau_matern": 1.0, "range_matern": 0.5},
                       {"sigma": 0.3})
    return cases


FORMULA_NEWDATA = {"IID (predict_cols)": {"group": np.array([0, 2, 3])},
                   "x + IID (predict_cols)": {"group": np.array([1, 3]), "x": np.array([0.5, -2.0])},
                   "Matern": {"px": np.array([0.2, 0.7]), "py": np.array([0.5, 0.4]), "z": np.array([1.0, -1.0])}}


def formula_terms(dev):
    """Phase 28(d) on `dev`: each case's components, posterior mean and std, and predicted η for new data."""
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.formula import build_formula_components, predict_cols

    out = {}
    with default_on(dev):
        for name, (formula, data, family, kw, th_prior, th_lik) in formula_term_cases().items():
            comps = build_formula_components(formula, data, family=family, **kw)
            prior = comps.combined_model(**on(th_prior, torch.float64, dev))
            post = tg.gaussian_approximation(prior, comps.obs_model(comps.y, **on(th_lik, torch.float64, dev)),
                                             options=tg.GAOptions(max_iter=50, mean_change_tol=1e-10,
                                                                  newton_dec_tol=1e-14))
            res = {"n": comps.A.shape[1], "constrained": comps.combined_model.constraints() is not None,
                   "mean": post.mean, "std": post.std(), "A": comps.A.todense()}
            if name in FORMULA_NEWDATA:
                A_new = predict_cols(comps, FORMULA_NEWDATA[name])
                res["A_new"] = A_new.todense()
                if A_new.shape[1] == comps.A.shape[1]:
                    res["eta_new"] = A_new.matvec(post.mean)
            out[name] = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in res.items()}
    return out


def formula_path(dev, card):
    """Phase 28: (a) geo at N = 10,000, (b) the disease maps at N = 10,000, (c) example 06 as written, (d) every term
    at the reference tests' sizes; the kernels counted from zero for (b), (c) and (d) and required there."""
    counts = {}
    t0 = time.perf_counter()
    W, bad = geo_cell(card)
    log(f"  (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bad += disease_map_cell(W, dev, card, counts)
    log(f"  (b) {time.perf_counter() - t0:.1f} s")
    v, secs = example_cell("phase 28(c) example 06", run_ex06, FORMULA_BASE_KERNELS
                           + ("dense_chol", "dense_trsv", "dense_selinv"), dev, counts)
    log(f"  (c) example 06 as written ({v['W edges']} contiguity edges, n={v['n']}, {v['dtype']}) in {secs:.2f} s on "
        f"{card}: aff {v['mean'][-1]:.4f} ± {1.96 * v['std'][-1]:.4f}, districts with P(RR>1) > 0.8: {v['p_exc']}")
    asserted(f"aff coefficient {v['mean'][-1]:.4f} within 3·1.96·std + 0.5 of 2.0",
             abs(v["mean"][-1] - 2.0) < 3 * 1.96 * v["std"][-1] + 0.5, bad)
    asserted(f"corr(η̂, η_true) {v['r']:.4f} > 0.9", v["r"] > 0.9, bad)
    asserted(f"BYM2 corr {v['r2']:.4f} > 0.85", v["r2"] > 0.85, bad)
    asserted("std finite", bool(np.all(np.isfinite(v["std"]))), bad)
    got, secs = example_cell("phase 28(d) formula terms", formula_terms, FORMULA_TERM_KERNELS, dev, counts)
    t0 = time.perf_counter()
    ref = formula_terms(torch.device("cpu"))
    log(f"  (d) every term on the card in {secs:.2f} s (the plain path on CPU tensors {time.perf_counter() - t0:.2f} "
        f"s), f64, kernels vs plain, on {card}:")
    for name, g in got.items():
        r = ref[name]
        tol = FORMULA_TOL["constrained" if g["constrained"] else "free"]
        errs = {k: float((g[k] - r[k]).abs().max() / r[k].abs().max().clamp_min(1e-300))
                for k in ("mean", "std", "eta_new") if k in g}
        same = all(bool(torch.equal(g[k], r[k])) for k in ("A", "A_new") if k in g)
        asserted(f"{name} (n={g['n']}{', constrained' if g['constrained'] else ''}): design equal {same}, "
                 + ", ".join(f"{k} max rel {e:.2e}" for k, e in errs.items()) + f" (tol {tol:.0e})",
                 same and all(e <= tol for e in errs.values()), bad)
    if bad:
        raise AssertionError(f"phase 28 failed: {bad}")
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

    log(f"  K1-K3 at the edges of their segmented scans, on {card}")
    for dt in (torch.float64, torch.float32):
        check_scan_edges(dt, dev)

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

    log(f"phase 3g the selected inverse's tangents K19-K22 vs plain and library: K19 at B={CHAINS} n={N}, K20 and "
        f"K21 over phase 3b's supernodal schedule, K22 and K21 on the banded blocks (n={sp_model.n}, B={SP_CHAINS}), "
        f"on {card}")
    results.update(check_tangent_kernels(sp_model, dev))
    log(f"phase 3h the factorizations' adjoints K23-K25 and the transpose modes vs plain and library: K23 at "
        f"B={CHAINS} n={N}, K24 and bt_sqrt's transpose on the banded blocks, K25 and K7's transpose over phase 3b's "
        f"schedule (n={sp_model.n}, B={SP_CHAINS}; the transposes at k={' and '.join(map(str, TRANSPOSE_KS))}), K7's "
        f"transpose at n={stats_model.n}, B=1, f32 and f64, on {card}")
    results.update(check_adjoint_kernels(sp_model, dev, stats_model))

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
    vg_counts = kernels.launches()
    state, accepts, hmc_ms = run_hmc(ld, z.to(dev), HMC_STEPS, STEP_SIZE, dev)
    counts = kernels.launches()
    # ---- end of the flagship main path ----
    launched(counts, FLAGSHIP_KERNELS, "flagship")
    k12 = ("tridiag_factor", "tridiag_solve")
    log(f"  K1 / K2 launches: phase 4's {1 + reps} value+grads {' / '.join(str(vg_counts[k]) for k in k12)}; "
        f"phase 5's HMC {' / '.join(str(counts[k] - vg_counts[k]) for k in k12)}")

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
    log(f"  K1 / K2 launches: phase 9's run_nuts {counts9['tridiag_factor']} / {counts9['tridiag_solve']}")
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
    log(f"phase 19 constrained Laplace: RW1({CON_N}) + Poisson, {CON_CHAINS} chains, f32; RW2({CON_N}), "
        f"{CON_RW2_CHAINS} chains, f64; on {card}")
    counts19 = constrained_path(dev, card)
    log(f"phase 20 areal models at example 08's size: Besag and BYM2 on the {AREAL_GRID}x{AREAL_GRID} grid, "
        f"example 08's τ-profile, on {card}")
    counts20 = areal_path(dev, card)
    log(f"phase 21 the examples' golden values: 01, 02 and 05, f32 and f64, on {card}")
    counts21 = examples_path(dev, card)
    log(f"phase 22 observation breadth: example 03 at n={sp_model.n} (LT Bernoulli, f32 and f64), normal/log "
        f"link AR1({N}) over {CHAINS} chains (f32), example 03 at its own size (f32 and f64); on {card}")
    counts22 = observation_path(sp_model, dev, card)
    log(f"phase 23 a non-Gaussian prior: the Student-t random walk, n={N}, {CHAINS} chains (f32, f64), and as an "
        f"AutoDiffLatentPrior ({ST_AD_CHAINS} chains, f64); on {card}")
    counts23 = nongaussian_path(dev, card)
    log(f"phase 24 second derivatives: θ-Hessians of the flagship (B={CHAINS}, f64 and f32), example 13, the "
        f"spatial slice (n={sp_model.n}, supernodal and auto -> banded, f64) and g={DN_GRID} (auto -> dense, f64); "
        f"d/dθ Σ var_i at n={stats_model.n}; on {card}")
    counts24 = hessian_path(sp_model, dn_model, stats_model, dev, card)
    log(f"phase 25 pathwise gradients through the factor: GMRF.sample (k={PATH_DRAWS}) and sqrt_matvec on the flagship "
        f"(B={CHAINS}), the spatial prior (n={sp_model.n}, supernodal and auto -> banded), g={DN_GRID} (auto -> dense); "
        f"pathwise against selected-inverse derivatives; the SPIKE logdet's gradient and solve's Hessian; on {card}")
    counts25 = pathwise_path(sp_model, dn_model, dev, card)
    log(f"phase 26 space-time and FEM breadth: example 04 (Nt=71, n=14,271); advection-diffusion at g={DN_GRID} "
        f"(ns={dn_model.n}, Nt={ST_NT}, n={dn_model.n * ST_NT}) with Poisson counts; examples 11, 14 and 15; on {card}")
    counts26 = fem_path(dn_model, dev, card)
    log(f"phase 27 samplers breadth on a one-rank NCCL mesh: run_smc, run_advi, run_nuts/run_hmc(mesh=) and "
        f"run_nuts_checkpointed on the flagship (B={MESH_FLAGSHIP['chains']}, n={N}, f32); example 12 parts 1-2; "
        f"example 07 (CAR N={EX07_RUN['N']}, auto -> dense); the dryrun_multichip twin; on {card}")
    counts27 = samplers_path(dev, card)
    log(f"phase 28 the formula interface and shapefile contiguity: example 06's districts at N={FORMULA_GRID ** 2} "
        f"through a .shp; the BYM and BYM2 disease maps (n={2 * FORMULA_GRID ** 2 + 2}, {FORMULA_CHAINS} chains, "
        f"f64); example 06 as written; every term at the reference tests' sizes; on {card}")
    counts28 = formula_path(dev, card)

    paths = (counts, sp_counts, counts9, counts10, counts11, counts12, counts13, counts13b, counts14, counts15,
             counts16, counts17, counts18, counts19, counts20, counts21, counts22, counts23, counts24, counts25,
             counts26, counts27, counts28)
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
