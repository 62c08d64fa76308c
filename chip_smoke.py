"""Smoke test of the PyTorch port (`hybrid_ode_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line of its own; any failure exits non-zero before
the last line:
  1. device   - require CUDA, print the card and its power limit, TF32 off
  2. build    - compile csrc/fused_rk4_fwd.cu, csrc/fused_rk4_bwd.cu and
                csrc/fused_rk4_bwd_vjp.cu with nvcc (sm_90a), all at once;
                ptxas registers / spills of each; the tile, grid, scratch and
                partials sizes both adjoint libraries report (and the second
                derivation's shared memory and route, both schedules)
                against pure-Python statements of their formulas over a grid
                of shapes
  3. kernel   - the fused RK4 forward kernel against its plain PyTorch
                version on the card: the accuracy checkpoint at full width on
                a cohort of 8192 windows (T=61, substeps=4, H=128, 16 context
                features), three small cases (2 layers without context,
                params 'mul', params 'abs'), the 'mul' case at B = 2, tile - 1
                and tile + 1 (the library says its tile) and a case too wide
                for the staged route (H=200); tolerance rtol=atol=2e-4, the
                JAX suite's fused-vs-XLA tolerance. Both adjoints must take
                the staged route at the cohort's widths (the second
                derivation in both schedules, also at the r2 checkpoint's
                params-mode widths) and the other one at H=200
  3b. bwd     - the adjoint kernel against its plain version: the same model
                on the cohort's first 1024 windows and the three small cases
                (B=1000, T=13), cotangent gbar from numpy (seed 0). Every
                output is compared (ybar0, each dW and db, the 17 summed
                parameter gradients, dctx) by the JAX suite's _rel_err:
                limit 1e-5 on the small cases; 1e-4 at full width, where a
                leaf that misses it passes only if the kernel is no farther
                from an f64 run of the plain version than the f32 plain is.
                The edge and wide cases of phase 3 as small cases too; the
                hand adjoint twice on the same full-width inputs is bitwise
                equal
  3c. vjp     - the second-derivation adjoint kernel ('recompute' and
                'chained') against its plain version (transposes from torch
                autograd) on the same inputs and with 3b's limits; on the
                small cases 'hand' against 'recompute' to 1e-5 as well. The
                probes on the full-width and the 'mul' case, probe_yw also at
                B = 2, tile - 1, tile + 1 and H=200: probe_yw's ybar0, dW, db
                and probe_y's ybar0 equal 'chained''s, every output a probe
                leaves out is exactly 0; 'recompute' and 'chained' each twice
                on the same inputs are bitwise equal
  3d. bf16    - mlp_dtype='bf16': the three kernels against their plain
                versions on the 'mul' small case (limit 1e-4), at full width
                over the first 7 grid points (limit 1e-3) and over all 61 (no
                fixed limit: two bf16 runs that sum in another order put
                operands on the other side of a rounding edge, 2^-8 of the
                operand each time, and 240 RK4 steps compound that). At every
                size each output must be nearer to the bf16 plain version
                than the f32 kernel's output on the same inputs is; the
                distance of the bf16 forward from f32 is printed
  4. main     - the serving path with every launch count at 0: evaluate the
                checkpoint (use_pallas) on the seed-42 test split against the
                JAX package's CPU metrics, then simulate the 8192 cohort with
                batched_forward(use_pallas); the kernel must have launched
  4b. train   - the training path with every launch count at 0: train_model
                for 3 epochs from the checkpoint's params and config
                (use_pallas) on the seed-42 split; the backward kernel must
                have launched >= 3 times, every loss be finite, final_model
                reload, and the first step's loss and gradient norm match the
                JAX package's CPU values to 1e-4; then init_hybrid_params and
                train_model (1 epoch, from scratch) with no device argument
                must give tensors on the card
  4c. identify - test-time identification with every launch count at 0:
                identify_context for ID_STEPS steps on the seed-42 test split
                with checkpoints/accuracy_benchmark_r2 (use_pallas,
                context_mode='params', H=128). The forward and the hand
                adjoint kernel must have launched >= ID_STEPS times, the
                mean misfit must not be above the encoder's, and both
                misfits match the JAX package's CPU values to 1e-4. Then the
                same gradient through bwd_impl='recompute' and 'chained':
                the new kernel must have launched and its dctx agree with
                'hand''s to 1e-4. Then, on the card as well, identify_params
                (scan solver, 5 steps: no window's misfit above its start's)
                and amortize_encoder on the dataset's 10 windows (finite
                losses, an encoder that encodes)
  4d. adaptive - the adaptive explicit solvers (plain PyTorch; they launch
                none of the fused kernels, every count is read 0 after them)
                with checkpoints/4gi_baseline_full (dopri5, scan, 8 steps
                per interval, H=64): (a) evaluate_checkpoint on the seed-42
                test split, every metric against the JAX package's CPU value
                to 1e-4; (b) train_model 1 epoch from its params, the first
                update's loss and gradient norm against JAX CPU constants to
                1e-4, solver_success 1; (c) the 8192-window cohort through
                batched_forward in scan, while, sync (global span), dense and
                dop853 while: median host ms of 3 (dop853: 2), accepted /
                rejected steps, success and host syncs each; while equal to
                scan to 1e-5, sync within 30 x rtol_eff of a dop853 f64 run
                (rtol 1e-10) on the first 64 windows (the other modes' distance
                printed); dense, whose free steps are chaotic across the meal
                boluses, run in f64 on those windows and held step by step to
                the host CPU's arithmetic on the card's own step inputs
                (dense_replay: inputs, results and outputs 1e-12, error norms
                1e-6, no accept decision differs, equal step counts), the free
                runs on both devices printed; one scan interval profiled
                (launches, device busy share); (d) the gradients of one MSE
                on 256 windows through backsolve and through the discrete scan
                adjoint: ODE parameters to the JAX suite's rtol 1e-3 / atol
                1e-8, MLP leaves to _rel_err BACKSOLVE_NN_RTOL (3 x the largest
                of backsolve_subsets.py's readings); (e) one scan-mode train
                step at the cohort shape, timed after one untimed
  4e. ensemble - the identified deep ensemble and the 4GI generator (plain
                PyTorch; they launch none of the fused kernels, every count is
                read 0 after them): (a) simulate_cohort (dopri5 'while', f32)
                of 50 subjects on numpy-drawn multipliers, each channel's sum
                against the JAX package's CPU value (COHORT_SUM_RTOL), and an
                8192-subject cohort timed; (b) that cohort's CSV
                (generate_4gi_dataset) read back through the native C++ route
                and the csv route, bitwise equal; (c) evaluate_checkpoint of
                checkpoints/ensemble_id (K=8, H=128) on the seed-42 test split,
                rmse, rmse_glucose and glucose vs truth against the JAX CPU
                values to 1e-4 (nll, coverage_90 printed); (d) the same with 5
                identification steps at 36 points, and the host ms per
                identification step; (e) one ensemble train step of the
                recipe from the checkpoint's params, the members' losses and
                gradient norms against JAX CPU constants to 1e-4, 2 more timed;
                (f) the launches of one forward at K=1 and K=8 (profiler), equal
                within 5%, with the device's busy share
  4f. bayes   - Bayesian inference (bayes_phase). NUTS on
                checkpoints/latent_hybrid_z (H=128, rk4, 4 substeps, no
                context) and the data file's first 8 windows: (a) the
                forward and the hand adjoint kernel in 'abs' mode with the 7
                sampled ODE parameters as context rows, 1024 chains = 8192
                lanes, against their plain versions (forward at all lanes,
                phase 3's limits; the adjoint on the first 1024 lanes, every
                leaf incl. the (1024, 7) dctx to 1e-4); (b) the fused chain
                log-posterior against the generic engine at 64 chains (value
                1e-5 (1 + |v|); gradient per parameter by phase 3's rule
                against an f64 generic run); (c) the first transition of
                those chains through both engines on identical draws: at
                least 61 of 64 agree on n_leapfrog with q within 1e-4;
                (d) nuts_sample on a correlated 7-d Gaussian, 1024 chains:
                means and covariances within the JAX suite's atol 0.12 /
                0.35, divergences below 1%; (e) the phase's main path, every
                count from 0: run_nuts(engine='fused') 1024 chains, 12 warmup
                transitions (the mass adapts) and 8 draws at depth 4: draws
                finite, mean accept statistic above 0.2, forward launches =
                adjoint launches = leapfrogs + initial gradients; R-hat,
                ESS, divergences, ms per fused leapfrog, host bookkeeping
                per leapfrog, leapfrogs / transitions / draws per s, host
                syncs per transition and one profiled transition's device
                busy share printed; (f) VI on the configs/4gi_vi.yaml recipe
                (template checkpoints/4gi_baseline_full, dopri5 scan): the
                first ELBO, KL and log-likelihood on JAX's replayed draws
                against JAX CPU constants to 1e-4, one step timed,
                save_checkpoint -> restore -> evaluate_model's VI branch on
                the test split (VI_EVAL_SAMPLES posterior samples) equal to
                the in-memory object's, no fused launch
  5. timing   - CUDA events, median of 20: forward and backward kernels at
                the cohort shape, one train step (fwd kernel + bwd kernel +
                loss + Adam) at the cohort shape and at bench.py's train
                shape (B=8192, T=61, H=64, no context); plain versions once;
                'recompute', 'chained' and the six probes with the
                decomposition of the adjoint they give; the bf16 forward and
                hand adjoint; identify_context per step at the test split's
                and the cohort's size; then one cohort train step under
                torch.profiler: device time per kernel and the device's busy
                share of the step
Then one JSON line with the three kernels, the card's name and power limit, and
last {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import contextlib
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import (
    batch_iterator,
    batch_to_tensors,
    create_data_arrays,
    split_dataset,
)
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.evals.evaluate import evaluate_checkpoint, glucose_truth_rmse
from hybrid_ode_torch.models.hybrid import (
    _Adam,
    batched_forward,
    config_from_dict,
    amortize_encoder,
    encode_context,
    forward_with_param_deltas,
    identify_context,
    identify_params,
    init_hybrid_params,
    with_context,
)
from hybrid_ode_torch.ops import fused_rk4
from hybrid_ode_torch.solvers import dense, explicit
from hybrid_ode_torch.solvers.tableaus import TABLEAUS
from hybrid_ode_torch.train.loop import TrainState, _to_params, make_optimizer, make_train_step, train_model
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "checkpoints" / "accuracy_benchmark" / "best_model"
CKPT_R2 = ROOT / "checkpoints" / "accuracy_benchmark_r2" / "best_model"
DATA = ROOT / "data" / "4gi_dataset.csv"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# JAX package, evaluate_checkpoint on the CPU (seq 61, stride 30, seed-42 split)
REF_RMSE, REF_RMSE_GLUCOSE = 0.3590921, 0.4897008
REF_RTOL = 1e-4
# JAX package, first train step on the CPU (the accuracy checkpoint's config
# with use_pallas, its params, the seed-42 split's first shuffled batch):
# loss and global gradient norm (tests/test_torch_training.py recomputes them)
REF_TRAIN_LOSS, REF_GRAD_NORM = 0.133601293, 2.02965832
# JAX package, identify_context on the CPU (the r2 checkpoint, ID_STEPS steps,
# the seed-42 test split): mean masked data misfit over the first 12 points at
# the encoder's codes and at the identified ones
# (tests/test_torch_identify.py recomputes them)
ID_STEPS = 30
REF_ID_MISFIT_ENCODER, REF_ID_MISFIT_IDENTIFIED = 0.0514110886, 0.0509036556
# JAX package, the dopri5 checkpoint on the CPU (its own config: scan, 8 steps
# per interval): evaluate_checkpoint on the seed-42 test split, every metric;
# and the first train step (the seed-42 train split's first shuffled batch, the
# physics intervals the port's generator seeded with the config's seed draws
# first): loss and global gradient norm (tests/test_torch_adaptive.py
# recomputes them)
ADAPTIVE_CKPT = ROOT / "checkpoints" / "4gi_baseline_full" / "best_model"
REF_ADAPTIVE_METRICS = {
    "rmse": 1.1807069400057741, "mae": 0.6766079897616254, "r2": -1.1330363946394106,
    "rmse_glucose": 0.9971208334015939, "mae_glucose": 0.8203335709308778,
    "rmse_insulin": 1.184468526310855, "mae_insulin": 0.8652231358857058,
    "rmse_glucagon": 1.2607577193621136, "mae_glucagon": 0.7758834428634861,
    "rmse_glp1": 2.0919544372522774, "mae_glp1": 1.5608573787173898,
    "rmse_ge": 0.0272807601195679, "mae_ge": 0.019285474150477013,
    "rmse_ffa": 0.02588413604784115, "mae_ffa": 0.018064936021816167,
    "ece": 0.05581967213114754, "msis": 8.994843961965355, "sharpness": 0.5795114462574323,
    "coverage_95": 0.8674863387978142, "mean_normalized_error": 1.0463511506465173,
    "coverage_80": 0.7513661202185792, "coverage_90": 0.825136612021858,
    "nll": 1.2622860557927722, "crps": 0.5348257017279912,
    "noise_sigma_glucose": 0.9184337171532059, "noise_sigma_insulin": 0.7279438327789035,
    "noise_sigma_glucagon": 1.1552590047517495, "noise_sigma_glp1": 0.5908636416548111,
    "noise_sigma_ge": 0.042790221102472506, "noise_sigma_ffa": 0.04177823171814396,
    "nrmse": 1.7999440431594849, "nrmse_glucose": 0.9520150684299548,
    "nrmse_insulin": 1.237323007187669, "nrmse_glucagon": 1.2339165373601262,
    "nrmse_glp1": 2.30037563088068, "nrmse_ge": 27280760119.567898,
    "nrmse_ffa": 25884136047.84115, "checkpoint_epoch": 106.0,
    "checkpoint_val_loss": 0.5244815349578857,
}
REF_ADAPTIVE_TRAIN_LOSS, REF_ADAPTIVE_GRAD_NORM = 1.1237022876739502, 5.447945594787598
# timed runs per adaptive mode (median), 2 for dop853, and timed scan train
# steps after one untimed: cut from 5 / 3 / 3 when phase 4e joined, so that
# the whole script stays well inside 20 minutes on a slow host (871.5 s with
# the old depths on an H100 machine whose host ran the scan forward 2.1x
# slower than another's)
ADAPTIVE_REPS = 3
ADAPTIVE_DOP853_REPS = 2
ADAPTIVE_STEP_REPS = 1
REF_SAMPLES = 64       # windows of the cohort held against a tight f64 run
# backsolve vs discrete adjoint on the cohort's first 256 windows: the ODE
# parameters are held elementwise to the JAX suite's limit (rtol 1e-3, atol
# 1e-8; test_backsolve_adjoint_close_to_discrete compares exactly those 17
# scalars, on a smooth f64 problem at rtol 1e-9). It holds on these windows
# (0.316 of it on an H100) but is no property of the method at this
# tolerance: windows 256-511 and 512-767 read 1.25 and 2.17 on the card and
# on the host CPU alike (backsolve_subsets.py), and the JAX package has the
# same gap (tests/test_torch_real_windows.py). An MLP leaf has elements near
# 0, where an elementwise rtol means nothing, so it is held by _rel_err, to 3x
# the largest of those three subsets' readings on the card (7.26e-4, 7.52e-4,
# 3.86e-4)
BACKSOLVE_NN_RTOL = 2.3e-3
# dense output in f64, the card against the host CPU's arithmetic on the card's
# own step inputs (chip_smoke.dense_replay): step inputs, results and outputs
# (_rel_err), and error norms relative to max(norm, the clamp floor)
DENSE_REPLAY_RTOL = 1e-12
DENSE_ERR_NORM_RTOL = 1e-6
# Phase 4e, the identified deep ensemble (checkpoints/ensemble_id: K=8 members,
# H=128, 4 layers, rk4 with 4 substeps, 'params' context mode) and the 4GI
# generator, each held against the JAX package on the CPU
# (tests/test_torch_ensemble.py and tests/test_torch_fourgi.py recompute them):
ENSEMBLE_CKPT = ROOT / "checkpoints" / "ensemble_id" / "ensemble_model"
# evaluate_checkpoint on the seed-42 test split: (rmse, rmse_glucose, nll,
# coverage_90, glucose RMSE against the noiseless truth in mmol/L), plain and
# with ENSEMBLE_ID_STEPS identification steps on the first ENSEMBLE_ID_POINTS
REF_ENSEMBLE_PLAIN = (0.34763877, 0.57617973, 5.8058872, 0.66256831, 0.89530986)
ENSEMBLE_ID_STEPS, ENSEMBLE_ID_POINTS = 5, 36
REF_ENSEMBLE_IDENTIFIED = (0.29557059071621217, 0.48058343176952173, 1.126309130800529,
                           0.7390710382513661, 0.6396914767183172)
# one ensemble train step from the checkpoint's params on the recipe's first
# train batch (configs/4gi_identified_ensemble.yaml: batch 8, lr 3e-3, clip 5,
# 2500 epochs, ODE params trained; lambda1 0, lambda2 0.01, no physics): the
# members' losses and global gradient norms
ENSEMBLE_RECIPE = {"batch_size": 8, "learning_rate": 3e-3, "gradient_clip": 5.0,
                   "epochs": 2500, "lambda1": 0.0, "lambda2": 0.01, "seed": 0}
REF_ENSEMBLE_STEP_LOSS = (0.08461064845323563, 0.08554180711507797, 0.08850155770778656,
                          0.08322668820619583, 0.08915844559669495, 0.09282763302326202,
                          0.08887159079313278, 0.09281761199235916)
REF_ENSEMBLE_STEP_GRAD_NORM = (1.3718622922897339, 1.4704915285110474, 0.4401543438434601,
                               0.3890090584754944, 0.17239989340305328, 3.4150195121765137,
                               0.3745898902416229, 0.24952460825443268)
# simulate_cohort (dopri5 'while', f32) of COHORT_SUBJECTS subjects on
# multipliers drawn with numpy (cohort_multipliers): the sum of each channel's
# concentrations. The limit is a reading's: the port on the host CPU is 1.6e-5
# from JAX (glucagon); a dopri5 stage that lands on a meal pulse's edge reads
# either interval's rate, so last bits move the solution
COHORT_SUBJECTS, COHORT_MULT_SEED = 50, 7
REF_COHORT_SUMS = {"glucose": 19243.38458585739, "insulin": 981046.668045044,
                   "glp1": 5295789.528271675, "glucagon": 120609.25552940369,
                   "gip": 545976.603764534}
COHORT_SUM_RTOL = 1e-3
# Phase 4f, Bayesian inference. NUTS on checkpoints/latent_hybrid_z (H=128,
# 4 layers, relu, rk4 with 4 substeps, no context, no 'norm' group: the
# repo's one full-width checkpoint the fused engine accepts), the first
# NUTS_WINDOWS windows of the data file in file order, z-scored with the
# checkpoint's statistics; NUTS_CHAINS chains fill NUTS_CHAINS x 8 = 8192
# lanes of one fused launch
NUTS_CKPT = ROOT / "checkpoints" / "latent_hybrid_z" / "best_model"
NUTS_WINDOWS = 8
NUTS_CHAINS = 1024
# chains held against the generic engine: (b) the log-posterior to the JAX
# suite's fused-vs-XLA limit 1e-5 (1 + |v|) (tests/test_pallas_kernel.py,
# there on a small model); the gradient by phase 3's full-width rule, each
# parameter's gradient over the chains a leaf: _rel_err against an f64 run of
# the generic engine within BWD_FULL_RTOL, or no farther from it than the f32
# generic engine. At full width the (1 + |g|) measure is no property of f32:
# where a chain's gradient is a sum of large terms that cancels, both f32
# engines sit 1e-4 to 4e-3 (1 + |g|) from f64 (the port's plain fused version
# and generic engine on the CPU, 16 chains, alike to within 10%). (c) the
# first transition on identical draws at NUTS_CMP_DEPTH (the generic
# engine's plain rk4 solve is launch-bound, about 11 s per gradient on the
# card)
NUTS_CMP_CHAINS, NUTS_CMP_DEPTH, NUTS_CMP_RTOL = 64, 1, 1e-5
# (e) run_nuts(engine='fused'): warmup (> 10, so the mass adapts), draws, depth
NUTS_WARMUP, NUTS_SAMPLES, NUTS_DEPTH = 12, 8, 4
# (d) nuts_sample on a correlated 7-d Gaussian: the JAX suite's limits
# (test_nuts_correlated_gaussian: means atol 0.12, covariances atol 0.35)
GAUSS_DIM, GAUSS_WARMUP, GAUSS_SAMPLES, GAUSS_DEPTH = 7, 40, 30, 5
GAUSS_MEAN_ATOL, GAUSS_COV_ATOL, GAUSS_DIV_RATE = 0.12, 0.35, 0.01
# (f) VI on the configs/4gi_vi.yaml recipe (PyYAML is not on the card: its
# settings are written here; tests/test_torch_bayes.py holds them to the YAML):
# the template checkpoints/4gi_baseline_full (dopri5 scan, H=64, 8 steps per
# interval), the seed-42 train split's first batch (VI_BATCH, padded)
VI_CKPT = ROOT / "checkpoints" / "4gi_baseline_full" / "best_model"
VI_PRIORS = {"a_GI": {"mean": 0.0104, "std": 0.002}, "k_I": {"mean": 0.025, "std": 0.005},
             "rho": {"mean": 0.003, "std": 0.001}, "E_max": {"mean": 0.1, "std": 0.02},
             "V_max": {"mean": 9.0, "std": 2.0}, "K_m": {"mean": 7.0, "std": 1.5},
             "k_L": {"mean": 0.02, "std": 0.005}}
VI_SETTINGS = {"n_samples": 5, "noise_sigma": 0.35, "include_nn": False}
VI_LR, VI_BATCH = 5e-4, 16
# the standard normal draws of the first VI step in the JAX package's key
# schedule: key = jax.random.split(jax.random.PRNGKey(0))[1] (the first step
# of train(seed=0)), split into the 5 samples, each split over the 8 sorted
# leaves (the 8 ODE parameters under the posterior: the 7 with priors and
# EC_50 under N(0, 1))
VI_EPS = {
    "ode_EC_50": (0.3190682828426361, -1.8768121004104614, 0.7226881980895996,
                  -0.10982715338468552, 0.7020218968391418),
    "ode_E_max": (0.5573172569274902, 2.215897560119629, 0.19253291189670563,
                  -0.8896790146827698, -0.37218838930130005),
    "ode_K_m": (1.3846383094787598, -0.43668580055236816, 0.0059644244611263275,
                -0.6523536443710327, 1.2605149745941162),
    "ode_V_max": (0.19345715641975403, -0.6488502025604248, -0.5742853879928589,
                  1.7110282182693481, -0.7791250944137573),
    "ode_a_GI": (-0.7641761302947998, 0.5012057423591614, 1.1411482095718384,
                 0.48966267704963684, -0.9759562015533447),
    "ode_k_I": (0.6996859908103943, 1.334916353225708, -1.020973801612854,
                -0.8813685774803162, 1.286223292350769),
    "ode_k_L": (-0.31554266810417175, 0.6040370464324951, -1.2810149192810059,
                0.024808909744024277, -0.11099724471569061),
    "ode_rho": (-0.34145769476890564, -0.054992854595184326, -0.7970839738845825,
                1.0478830337524414, -1.492479681968689),
}
# the JAX package on the CPU, that step's ELBO, KL and log-likelihood (before
# the update), held to REF_RTOL
REF_VI_ELBO, REF_VI_KL, REF_VI_LOGLIK = -12632.9921875, 1262.971435546875, -11370.0205078125
# posterior samples of the VI evaluation on the seed-42 test split: cut from
# the CLI's default 100 to fit the phase's time (one batched solve either way)
VI_EVAL_SAMPLES = 20
RTOL = ATOL = 2e-4
COHORT = 8192          # bench.py's cohort size
SUBSTEPS = 4
BWD_B = 1024           # windows of the cohort for the adjoint's kernel-vs-plain check
BWD_SMALL_RTOL, BWD_FULL_RTOL = 1e-5, 1e-4
# mlp_dtype='bf16', kernel against plain version (_rel_err): small case and
# full width over BF16_SHORT_T grid points. Over all grid points rounding edges
# compound and no fixed limit separates a right kernel from a wrong one; there,
# as at every size, each output must be nearer to the bf16 plain version than
# the f32 kernel (a kernel that rounds nothing) is on the same inputs.
BF16_SMALL_RTOL, BF16_SHORT_RTOL = 1e-4, 1e-3
BF16_SHORT_T = 7
# the kernels' times before their redesign for Hopper, at the cohort shape on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): printed beside
# this run's times as not measured in this run and written to chip_smoke.json,
# not part of the kernels line, which holds only what this run measured
PREVIOUS_MS = {"fused_rk4_fwd": 68.289, "fused_rk4_bwd": 205.865,
               "fused_rk4_bwd_vjp": 250.506, "fused_rk4_bwd_vjp_chained": 211.708}
PROBES = ("probe_y", "probe_yw", "probe_y_mlp", "probe_y_mech", "probe_fwd1", "probe_fwd2")
# NVIDIA H100 SXM data sheet, 700 W: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SMEM_LIMIT = 232448  # bytes of shared memory a block can get on sm_90
# operations per sample outside the MLP, counted from the kernel's formulas:
# mechanistic drift + residual add + stage state + control interpolation per
# stage evaluation, and the RK4 combination per step
MECH_OPS_PER_STAGE = 61
RK_OPS_PER_STEP = 48
# ... and for the adjoint: mechanistic Jacobian-transpose, parameter rows and
# stage cotangents per stage, the substep's cotangent sum per step
MECH_T_OPS_PER_STAGE = 124
RK_T_OPS_PER_STEP = 30


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def compare(kernel, plain, label):
    k, p = kernel.double(), plain.double()
    if not torch.isfinite(k).all():
        fail(f"{label}: kernel output is not finite")
    err = (k - p).abs()
    ratio = float((err / (ATOL + RTOL * p.abs())).max())
    max_abs = float(err.max())
    max_rel = float((err / p.abs().clamp_min(1e-6)).max())
    ok = ratio <= 1.0
    print(f"kernel-vs-plain {label}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"worst |k-p|/(atol+rtol|p|)={ratio:.3f} (rtol=atol={RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version")
    return max_abs


def cohort_inputs(ds, params, config, device, n=COHORT):
    """The dataset's windows tiled to n samples with numpy-seeded jitter."""
    rng = np.random.default_rng(0)
    idx = np.arange(n) % len(ds)
    obs = ds.observations[idx].copy()
    obs[..., :4] += 0.05 * rng.normal(size=obs[..., :4].shape).astype(np.float32)
    ts = ds.time_points[idx] + rng.uniform(0.0, 24.0, (n, 1)).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=device) for k, v in (
        ("observations", obs), ("time_points", ts), ("initial_state", obs[:, 0]))}
    ext = {"meal": torch.as_tensor(ds.meal[idx], device=device),
           "tVNS": torch.as_tensor(ds.tvns[idx], device=device)}
    with torch.no_grad():
        ctrl = with_context(params, batch, Controls(ts=batch["time_points"], signals=ext), config)
    return batch, ctrl


def random_mlp(rng, in_dim, hidden, n_layers, device):
    dims = [in_dim] + [hidden] * n_layers + [6]
    nn = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        scale = 0.05 if i == n_layers else 1.0 / np.sqrt(a)
        nn[f"w{i}"] = (scale * rng.normal(size=(a, b))).astype(np.float32)
        nn[f"b{i}"] = (0.1 * rng.normal(size=b)).astype(np.float32)
    return params_from_numpy(nn, device)


def small_case(name, ode, device, n_layers, mode, B=1000, hidden=64):
    """A small random-weight case for one kernel option."""
    rng = np.random.default_rng({"layers2": 1, "mul": 2, "abs": 3}.get(name, 4))
    T = 13  # B = 1000 is not a multiple of the block's tile: exercises masking
    y0 = (0.5 * rng.normal(size=(B, 6))).astype(np.float32)  # z-scored states
    ts = np.cumsum(rng.uniform(0.05, 0.15, (B, T)), 1).astype(np.float32)
    meal = np.where(rng.uniform(size=(B, T)) > 0.7, 1.0, 0.0).astype(np.float32)
    tvns = rng.uniform(0, 1, (B, T)).astype(np.float32)
    names = ("G_b", "I_b", "Glu_b")
    idx, ctx = (), None
    if mode:
        idx = tuple(fused_rk4.PARAM_ORDER.index(n) for n in names)
        if mode == "mul":
            ctx = (0.2 * rng.normal(size=(B, 3))).astype(np.float32)
        else:
            base = np.array([float(ode[n]) for n in names], np.float32)
            ctx = (base * (1 + 0.2 * rng.normal(size=(B, 3)))).astype(np.float32)
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    packed = fused_rk4.pack(t(y0), t(ts), t(meal), t(tvns), ode,
                            random_mlp(rng, 9, hidden, n_layers, device), n_layers, t(ctx))
    return packed, idx, mode or "mul"


def time_ms(fn, warmup, reps):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(ref, x):
    """The JAX suite's _rel_err: max |ref - x| over max |ref|."""
    ref, x = ref.double(), x.double()
    return float((ref - x).abs().max() / max(float(ref.abs().max()), 1e-8))


def bwd_leaves(out, pw):
    """The adjoint's outputs as named leaves: ybar0, dW / db per layer, the
    17 parameter gradients summed over the batch (in f64), dctx."""
    ybar0, dflat, dp, dctx = out
    v = fused_rk4._unflatten(dflat, pw.in_pad, pw.hidden, pw.n_layers)
    n_par = fused_rk4.N_PARAMS  # 'recompute' returns the (32,) row already summed
    leaves = {"ybar0": ybar0, "dparams": dp[:n_par].double() if dp.ndim == 1 else dp.double().sum(1)}
    for i in range(pw.n_layers + 1):
        leaves[f"dw{i}"], leaves[f"db{i}"] = v.ws[i], v.bs[i]
    if dctx is not None:
        leaves["dctx"] = dctx
    return leaves


def bwd_inputs(packed, T, substeps, idx=(), mode="mul", mlp_dtype="f32"):
    """Forward-kernel trajectory and a numpy-seeded cotangent for `packed`."""
    B = packed[0].shape[0]
    with torch.no_grad():
        traj = fused_rk4.fused_rk4_fwd(*packed, substeps, idx, mode, mlp_dtype)
    gbar = np.random.default_rng(0).normal(size=(T, 6, B)).astype(np.float32)
    return traj, torch.as_tensor(gbar, device=traj.device)


def compare_bwd(packed, T, substeps, label, idx=(), mode="mul", full=False, impl="hand",
                mlp_dtype="f32", limit=None, f64=None):
    """An adjoint kernel vs its plain version on the forward kernel's
    trajectory; returns (max abs error, plain seconds, kernel leaves, f64
    leaves). `impl` 'hand' is fused_rk4_bwd, anything else fused_rk4_bwd_vjp.
    With `full`, a leaf that misses the limit passes if the kernel is no
    farther from the f64 plain run (`f64`, computed here when not given) than
    the f32 plain is. With mlp_dtype 'bf16' every leaf must also be nearer to
    the plain version than the f32 kernel's on the same inputs is, and `limit`
    may be inf to leave that as the only rule."""
    traj, gbar = bwd_inputs(packed, T, substeps, idx, mode, mlp_dtype)
    args = (traj, gbar, *packed[1:], substeps, idx, mode, mlp_dtype)
    if impl == "hand":
        kernel_fn, plain_fn = fused_rk4.fused_rk4_bwd, fused_rk4._bwd_plain
    else:
        kernel_fn = lambda *a: fused_rk4.fused_rk4_bwd_vjp(*a, impl)  # noqa: E731
        plain_fn = lambda *a: fused_rk4._bwd_vjp_plain(*a, impl)  # noqa: E731
    with torch.no_grad():
        kernel = bwd_leaves(kernel_fn(*args), packed[5])
        unrounded = (bwd_leaves(kernel_fn(*args[:-1], "f32"), packed[5])
                     if mlp_dtype == "bf16" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = bwd_leaves(plain_fn(*args), packed[5])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if full and f64 is None:
            d = lambda x: None if x is None else x.double()  # noqa: E731
            pw = packed[5]
            pw64 = fused_rk4._unflatten(pw.flat.double(), pw.in_pad, pw.hidden, pw.n_layers)
            f64 = bwd_leaves(fused_rk4._bwd_plain(
                d(traj), d(gbar), *(d(x) for x in packed[1:5]), pw64, d(packed[6]), substeps,
                idx, mode), pw)
    if limit is None:
        limit = BWD_FULL_RTOL if full else BWD_SMALL_RTOL
    max_abs, parts, bad = 0.0, [], []
    for name, k in kernel.items():
        if not torch.isfinite(k).all():
            bad.append(f"{name} not finite")
        e = rel_err(plain[name], k)
        max_abs = max(max_abs, float((k.double() - plain[name].double()).abs().max()))
        part = f"{name} {e:.2e}"
        if full:
            dk, dp = rel_err(f64[name], k), rel_err(f64[name], plain[name])
            part += f" (f64: kernel {dk:.2e}, plain {dp:.2e})"
            if e > limit and dk > dp:
                bad.append(name)
        elif e > limit:
            bad.append(name)
        if unrounded is not None:
            du = rel_err(plain[name], unrounded[name])
            part += f" (f32 kernel {du:.2e})"
            if not e < du and name not in bad:
                bad.append(name)
        parts.append(part)
    print(f"bwd '{impl}' {mlp_dtype} kernel-vs-plain {label} (_rel_err limit {limit:g}): "
          + "; ".join(parts) + f" {'FAIL ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        fail(f"bwd '{impl}' {label}: kernel disagrees with its plain version ({', '.join(bad)})")
    return max_abs, plain_s, kernel, f64


def compare_leaves(a, b, label, limit, names=None):
    """Two sets of adjoint leaves against each other (_rel_err of b on a)."""
    errs = {n: rel_err(a[n], b[n]) for n in (names or a)}
    bad = [n for n, e in errs.items() if not e <= limit]
    print(f"{label} (_rel_err limit {limit:g}): " + "; ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" {'FAIL ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        fail(f"{label}: {', '.join(bad)} disagree")


def check_probes(packed, T, substeps, label, idx, mode, chained, probes=PROBES):
    """The probes of the second-derivation kernel on these inputs: what each
    computes equals 'chained', what it leaves out is exactly 0."""
    traj, gbar = bwd_inputs(packed, T, substeps, idx, mode)
    for probe in probes:
        with torch.no_grad():
            out = bwd_leaves(fused_rk4.fused_rk4_bwd_vjp(traj, gbar, *packed[1:], substeps, idx,
                                                         mode, "f32", probe), packed[5])
        torch.cuda.synchronize()
        same = {"probe_y": ["ybar0"],
                "probe_yw": ["ybar0"] + [n for n in out if n[:2] in ("dw", "db")]}.get(probe, [])
        zero = [n for n in out if n != "ybar0" and n not in same]
        nonzero = [n for n in zero if float(out[n].abs().max()) != 0.0]
        if nonzero or not torch.isfinite(out["ybar0"]).all():
            fail(f"{probe} {label}: outputs it leaves out are not 0: {nonzero}")
        if same:
            compare_leaves(chained, out, f"{probe} vs 'chained' {label}; {len(zero)} outputs "
                           "exactly 0", 1e-6, same)
        else:
            print(f"{probe} {label}: ybar0 finite, {len(zero)} outputs exactly 0 ok")


def compare_bf16(packed, T, substeps, label, idx, mode, limit):
    """mlp_dtype='bf16': each of the three kernels vs its plain version, within
    `limit` and nearer than the f32 kernel on the same inputs; returns the
    forward's (kernel, error to plain, the f32 kernel's distance to plain)."""
    with torch.no_grad():
        k = fused_rk4.fused_rk4_fwd(*packed, substeps, idx, mode, "bf16")
        k32 = fused_rk4.fused_rk4_fwd(*packed, substeps, idx, mode, "f32")
        torch.cuda.synchronize()
        plain = fused_rk4._fwd_plain(*packed, substeps, idx, mode, "bf16")
        e, du = rel_err(plain, k), rel_err(plain, k32)
    ok = e <= limit and e < du
    print(f"fwd bf16 kernel-vs-plain {label} (_rel_err limit {limit:g}): {e:.2e} "
          f"(f32 kernel {du:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"bf16 forward {label}: kernel disagrees with its plain version")
    for impl in ("hand", "recompute", "chained"):
        compare_bwd(packed, T, substeps, label, idx, mode, impl=impl, mlp_dtype="bf16", limit=limit)
    return k, e, du


def kernel_ops(nn, n_layers, hidden, B, T, substeps, n_ctx_feat=0):
    """Operations of the forward and the adjoint kernel on these shapes,
    counted from the kernels' formulas (unpadded MLP widths)."""
    macs = sum(nn[f"w{i}"].numel() for i in range(n_layers + 1))
    outs = sum(nn[f"b{i}"].numel() for i in range(n_layers + 1))
    hidden_outs = n_layers * hidden
    steps = B * (T - 1) * substeps
    fwd = steps * (4 * (2 * macs + outs + hidden_outs + MECH_OPS_PER_STAGE) + RK_OPS_PER_STEP)
    # the adjoint: one recomputed forward, then per stage the weight and input
    # cotangents (2 x 2 macs), bias sums, ReLU masks and the mechanistic transpose
    bwd = fwd + steps * (4 * (4 * macs + outs + hidden_outs + MECH_T_OPS_PER_STAGE + n_ctx_feat)
                         + RK_T_OPS_PER_STEP)
    return fwd, bwd


def id_misfit(params, batch, config, ctx, k):
    """Mean over windows of the masked, weighted data misfit over the first
    k points, rolled out with the codes `ctx` (identify_context's objective
    without its trust region)."""
    ts_k = batch["time_points"][:, :k]
    sig = {n: v[:, :k] for n, v in batch["external_inputs"].items()}
    with torch.no_grad():
        preds = batched_forward(params, batch["initial_state"], ts_k,
                                Controls(ts=ts_k, signals=dict(sig, context=ctx)), config)
    m = batch["mask"][:, :k]
    se = (preds - batch["observations"][:, :k]) ** 2 * batch["loss_weights"] * m[..., None]
    per_window = se.sum((1, 2)) / torch.clamp(m.sum(1) * se.shape[-1], min=1.0)
    return float(per_window.mean())


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def train_step_fn(params, batch, config, lambda2, device=torch.device("cuda")):
    """One train step (forward, backward, loss, Adam) as a closure."""
    state = TrainState(_to_params(params, device))
    opt = make_optimizer(3e-3, 1000, 1, 5.0, train_ode_params=True).bind(state.params)
    step = make_train_step(opt, config, 0.0, lambda2, True)
    gen = torch.Generator().manual_seed(0)
    return lambda: step(state, batch, gen)


def profile_ms(fn, warm=True):
    """One profiled call of fn (after an unprofiled one unless `warm` is
    False): (wall ms, {kernel name: (device ms, launches)}). Wall time is the
    host clock around fn and a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall_ms, kernels


def bench_train_batch(device):
    """bench.py's train-step inputs: B=8192, T=61 on one 5 h grid, two meals."""
    rng = np.random.default_rng(1)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2], np.float32)
    y0 = np.abs(base * (1.0 + 0.1 * rng.normal(size=(COHORT, 6)))).astype(np.float32)
    ts = np.broadcast_to(np.linspace(0.0, 5.0, 61, dtype=np.float32), (COHORT, 61))
    meal = np.zeros((COHORT, 61), np.float32)
    meal[:, 12], meal[:, 36] = 2.0, 1.5
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)  # noqa: E731
    return {"initial_state": t(y0), "observations": t(np.repeat(y0[:, None], 61, 1)),
            "time_points": t(ts), "external_inputs": {"meal": t(meal),
                                                      "tVNS": t(np.zeros_like(meal))}}


def backsolve_vs_discrete(params, config, batch, ctrl, sel):
    """Parameter gradients of one MSE on the windows `sel` through
    adjoint='backsolve' and through the discrete scan adjoint: (the worst ODE
    parameter's |b - d| / (1e-8 + 1e-3 |d|), the JAX suite's
    test_backsolve_adjoint_close_to_discrete limit on those 17 scalars, with
    its name, d and b; the worst MLP leaf's _rel_err; seconds of each)."""
    y0, ts = batch["initial_state"][sel], batch["time_points"][sel]
    ctrl_b = Controls(ts=ts, signals={k: v[sel] for k, v in ctrl.signals.items()})
    grads, seconds = {}, {}
    for adjoint in ("discrete", "backsolve"):
        leaves = {(g, k): v.clone().requires_grad_(True) for g, grp in params.items()
                  for k, v in grp.items()}
        p = {g: {k: leaves[(g, k)] for k in grp} for g, grp in params.items()}
        t0 = time.perf_counter()
        preds = batched_forward(p, y0, ts, ctrl_b, dataclasses.replace(config, adjoint=adjoint))
        loss = torch.mean((preds - batch["observations"][sel]) ** 2)
        grads[adjoint] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        seconds[adjoint] = time.perf_counter() - t0
    worst_ode, worst_nn = (0.0, None, None, None), 0.0
    for key, gd in grads["discrete"].items():
        gb, gd = grads["backsolve"][key].double(), gd.double()
        if key[0] == "ode":
            r = float((gb - gd).abs() / (1e-8 + 1e-3 * gd.abs()))
            worst_ode = max(worst_ode, (r, key[1], float(gd), float(gb)), key=lambda w: w[0])
        else:
            worst_nn = max(worst_nn, rel_err(gd, gb))
    return worst_ode, worst_nn, seconds


@contextlib.contextmanager
def dense_steps(wrap):
    """While the block runs, every trial step of the dense-output solvers
    goes through wrap(step_fn, *step_inputs)."""
    solve = dense._dense_solve

    def wrapped(step_fn, *args, **kwargs):
        return solve(lambda *inputs: wrap(step_fn, *inputs), *args, **kwargs)

    dense._dense_solve = wrapped
    try:
        yield
    finally:
        dense._dense_solve = solve


def _host_stats(st):
    return explicit.StepStats(*(v.cpu() for v in st))


def to_host(params):
    return {g: {k: v.cpu() for k, v in grp.items()} for g, grp in params.items()}


def dense_replay(params, y0, ts, ctrl, config):
    """Dense output on the card with every trial step recorded, then the same
    solve on the host CPU with each trial step's results replaced by the
    card's, so the host's loop walks the card's steps. Worst differences
    (_rel_err unless said): the host loop's inputs to each step (t, y, f(t, y),
    h; theta follows from them) against the card's; each step's results (y1,
    f(t+h, y1), the outputs' interpolants) computed by the host from those
    inputs against the card's; the error norms, relative to max(norm, the
    floor below which the step factor is clamped at MAX_FACTOR, so the last
    digits of a smaller norm change no step); the accept decisions that
    differ; the outputs; whether the step counts are equal."""
    record = []

    def on_card(step_fn, *inputs):
        res = step_fn(*inputs)
        record.append(([x.cpu() for x in inputs[:4]], [x.cpu() for x in res]))
        return res

    with dense_steps(on_card), torch.no_grad():
        ys, st = batched_forward(params, y0, ts, ctrl, config, return_stats=True)
    steps = iter(record)
    floor = (explicit.SAFETY / explicit.MAX_FACTOR) ** (TABLEAUS[config.solver].error_order + 1)
    worst = {"inputs": 0.0, "results": 0.0, "err_norm": 0.0, "flips": 0}

    def on_host(step_fn, *inputs):
        card_in, card_res = next(steps)
        res = step_fn(*inputs)
        worst["inputs"] = max([worst["inputs"]] + [rel_err(c, x) for c, x in zip(card_in, inputs)])
        worst["results"] = max([worst["results"]] + [rel_err(card_res[i], res[i])
                                                     for i in (0, 1, 3)])
        e_card, e_host = card_res[2], res[2]
        worst["err_norm"] = max(worst["err_norm"], float(
            ((e_card - e_host).abs() / e_host.clamp(min=floor)).max()))
        worst["flips"] += int(((e_card <= 1.0) != (e_host <= 1.0)).sum())
        return tuple(card_res)

    ctrl_h = Controls(ts=ctrl.ts.cpu(), signals={k: v.cpu() for k, v in ctrl.signals.items()})
    with dense_steps(on_host), torch.no_grad():
        ys_h, st_h = batched_forward(to_host(params), y0.cpu(), ts.cpu(), ctrl_h, config,
                                     return_stats=True)
    st_c = _host_stats(st)
    worst.update(trial_steps=len(record), err_floor=floor, outputs=rel_err(ys.cpu(), ys_h),
                 steps_equal=bool((st_c.n_accepted == st_h.n_accepted).all()
                                  and (st_c.n_rejected == st_h.n_rejected).all()),
                 ys=ys, stats=st, trace=[(i[0], i[3], r[2]) for i, r in record])
    return worst


def dense_trace(run):
    """run() with each dense trial step's (t, h, error norm) recorded:
    (result, trace)."""
    trace = []

    def record(step_fn, *inputs):
        res = step_fn(*inputs)
        trace.append((inputs[0], inputs[3], res[2]))
        return res

    with dense_steps(record), torch.no_grad():
        return run(), trace


def divergence(trace_a, trace_b):
    """Two dense runs' per-step (t, h, error norm) traces: the first trial
    step at which the windows' largest relative difference of h exceeds each
    of 0, 1e-12, 1e-9, 1e-6 and 1e-3, and the first at which an accept
    decision differs. Growth over many steps is the chaotic controller; a
    jump from 0 to a large difference at one step would be a fault."""
    drift = [float(((a[1] - b[1]).abs() / a[1].abs()).max()) for a, b in zip(trace_a, trace_b)]
    first = {f"{lv:g}": next((i for i, x in enumerate(drift) if x > lv), None)
             for lv in (0.0, 1e-12, 1e-9, 1e-6, 1e-3)}
    first["accept"] = next((i for i, (a, b) in enumerate(zip(trace_a, trace_b))
                            if bool(((a[2] <= 1.0) != (b[2] <= 1.0)).any())), None)
    return first


def adaptive_phase(ds, train_ds, val_ds, test_ds, device, smi, n=COHORT):
    """Phase 4d: the adaptive explicit solvers on `device` with the dopri5
    checkpoint; returns the report's entries. Fails on any check."""
    out = {}
    # (a) evaluation with the checkpoint's own config (dopri5, scan, 8 steps)
    t0 = time.perf_counter()
    metrics = evaluate_checkpoint(str(ADAPTIVE_CKPT), test_ds, val_ds=val_ds, device=device)
    eval_s = time.perf_counter() - t0
    rels = {k: abs(metrics[k] - ref) / max(abs(ref), 1e-12)
            for k, ref in REF_ADAPTIVE_METRICS.items()}
    worst = max(rels, key=rels.get)
    print(f"adaptive (a): evaluate_checkpoint {ADAPTIVE_CKPT.parent.name} (dopri5 scan) in "
          f"{eval_s:.2f} s: rmse={metrics['rmse']:.7f} (JAX-CPU {REF_ADAPTIVE_METRICS['rmse']}); "
          f"worst of {len(rels)} metrics {worst} rel_err={rels[worst]:.2e} (limit {REF_RTOL})")
    if sorted(metrics) != sorted(REF_ADAPTIVE_METRICS) or rels[worst] > REF_RTOL:
        fail(f"adaptive evaluation: {worst} disagrees with the JAX reference")
    out["eval"] = {"metrics": metrics, "seconds": eval_s, "worst_rel_err": rels[worst]}

    # (b) training: the first update against JAX, one epoch within budget
    state, meta = load_checkpoint(str(ADAPTIVE_CKPT))
    cfg = copy.deepcopy(meta["config"])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        res = train_model(cfg, train_ds, val_ds, ckpt_dir, None, params=state["params"],
                          max_epochs=1, device=device)
        train_s = time.perf_counter() - t0
    hist = res.history
    print(f"adaptive (b): train_model 1 epoch in {train_s:.2f} s; step losses "
          f"{hist['step_loss']}, grad norms {hist['grad_norm']}, solver_success "
          f"{hist['solver_success']}")
    for key, got, ref in (("loss", hist["step_loss"][0], REF_ADAPTIVE_TRAIN_LOSS),
                          ("grad_norm", hist["grad_norm"][0], REF_ADAPTIVE_GRAD_NORM)):
        rel = abs(got - ref) / ref
        print(f"adaptive (b): first train step {key}={got:.9f} JAX-CPU reference={ref} "
              f"rel_err={rel:.2e} (limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"adaptive first train step {key} disagrees with the JAX reference")
    if min(hist["solver_success"]) < 1.0 or not np.isfinite(hist["step_loss"]).all():
        fail("adaptive training exhausted a step budget or lost finiteness")
    out["train"] = {"history": hist, "seconds": train_s}

    # (c) the cohort through every adaptive mode, forward only
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(cfg)
    batch, ctrl = cohort_inputs(ds, params, config, device, n)
    y0, ts = batch["initial_state"], batch["time_points"]
    runs = {"scan": {}, "while": {"mode": "while"}, "sync": {"mode": "sync"},
            "dense": {"mode": "dense"}, "dop853 while": {"solver": "dop853", "mode": "while"}}
    ys, cohort = {}, {}
    for name, over in runs.items():
        cfg_r = dataclasses.replace(config, **over)
        reps = ADAPTIVE_DOP853_REPS if name == "dop853 while" else ADAPTIVE_REPS

        def run():
            with torch.no_grad():
                return batched_forward(params, y0, ts, ctrl, cfg_r, return_stats=True)

        times = []
        for _ in range(reps):  # the first run's set-up is inside the median's reach
            syncs = explicit.host_syncs
            t0 = time.perf_counter()
            ys[name], st = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            syncs = explicit.host_syncs - syncs
        y = ys[name]
        if (y.shape != (n, ts.shape[1], 6) or y.device.type != device.type
                or not torch.isfinite(y).all()):
            fail(f"adaptive {name}: output of the wrong shape, device or not finite")
        acc, rej = st.n_accepted.double(), st.n_rejected.double()
        cohort[name] = {"ms": statistics.median(times), "reps": reps, "host_syncs": syncs,
                        "accepted": float(acc.mean()), "rejected": float(rej.mean()),
                        "success": float(st.success.double().mean()),
                        "per_sample_stats": st.n_accepted.ndim > 0}
    for name, c in cohort.items():
        print(f"adaptive (c) ({smi}): {name} at B={n} T={ts.shape[1]} H={config.nn_hidden}: "
              f"median {c['ms']:.1f} ms of {c['reps']}; accepted {c['accepted']:.2f} "
              f"rejected {c['rejected']:.2f} per {'sample' if c['per_sample_stats'] else 'batch'}"
              f"; success {c['success']:.4f}; host syncs {c['host_syncs']}")
    # where a scan forward's time goes: one interval (8 masked trial steps)
    # under the profiler, its launches and the device's busy share
    ctrl1 = Controls(ts=ts[:, :2], signals={k: v[:, :2] for k, v in ctrl.signals.items()})
    with torch.no_grad():
        wall_ms, kernels = profile_ms(lambda: batched_forward(params, y0, ts[:, :2], ctrl1,
                                                              config))
    busy_ms = sum(ms for ms, _ in kernels.values())
    launches = sum(k for _, k in kernels.values())
    print(f"adaptive (c) profile ({smi}): one scan interval at B={n}: wall {wall_ms:.1f} ms, "
          f"{launches} kernel launches, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    out["scan_interval_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                                    "launches": launches}
    e = rel_err(ys["scan"], ys["while"])
    print(f"adaptive (c): 'while' vs 'scan' _rel_err {e:.2e} (limit 1e-5)")
    if not e <= 1e-5:
        fail("adaptive 'while' disagrees with 'scan'")
    # a tight f64 per-sample reference on the first REF_SAMPLES windows
    sub = slice(0, REF_SAMPLES)
    p64 = {g: {k: v.double() for k, v in grp.items()} for g, grp in params.items()}
    ctrl64 = Controls(ts=ts[sub].double(), signals={k: v[sub].double()
                                                   for k, v in ctrl.signals.items()})
    cfg64 = dataclasses.replace(config, solver="dop853", mode="while", rtol=1e-10, atol=1e-12,
                                max_steps_per_interval=256)
    with torch.no_grad():
        ref, ref_st = batched_forward(p64, y0[sub].double(), ts[sub].double(), ctrl64, cfg64,
                                      return_stats=True)
    if not bool(ref_st.success.all()):
        fail("the f64 reference exhausted its step budget")
    limit = 30.0 * explicit._effective_tols(config.rtol, config.atol, torch.float32)[0]
    for name in runs:
        cohort[name]["rel_err_vs_f64"] = rel_err(ref, ys[name][sub])
    print(f"adaptive (c): vs a dop853 f64 per-sample run (rtol 1e-10) on the first "
          f"{REF_SAMPLES} windows: " + ", ".join(f"'{k}' {v['rel_err_vs_f64']:.2e}"
                                                 for k, v in cohort.items())
          + f" (limit for sync {limit:.2e} = 30 x rtol_eff)")
    if not cohort["sync"]["rel_err_vs_f64"] <= limit:
        fail("adaptive sync is farther than 30 x rtol_eff from the f64 reference")
    # Dense output free-runs across the cohort's gridded meal boluses with no
    # forced step boundary. Where a step's stages fall on a bolus's edge, a
    # small shift of the step moves the error norm by orders of magnitude, so
    # last-bit differences grow from step to step until an accept flips: the
    # step sequence is chaotic there, in the JAX package as in the port
    # (tests/test_torch_real_windows.py::test_dense_output_at_the_checkpoint_
    # tolerance_is_ill_conditioned_in_both_packages). Free runs on two devices
    # are then not comparable. The card's f64 run on these windows and
    # controls is held step by step to the host CPU's arithmetic instead; the
    # free runs are printed.
    cfg_d = dataclasses.replace(config, mode="dense")
    y64, ts64 = y0[sub].double(), ts[sub].double()
    d = dense_replay(p64, y64, ts64, ctrl64, cfg_d)
    print(f"adaptive (c): dense in f64 on the first {REF_SAMPLES} windows, {device.type} vs the "
          f"host CPU step by step over {d['trial_steps']} trial steps: step inputs "
          f"{d['inputs']:.2e} (limit {DENSE_REPLAY_RTOL:g}), step results {d['results']:.2e} "
          f"(limit {DENSE_REPLAY_RTOL:g}), error norms {d['err_norm']:.2e} relative above "
          f"{d['err_floor']:.2e} (limit {DENSE_ERR_NORM_RTOL:g}), accept decisions that differ "
          f"{d['flips']} (limit 0), outputs {d['outputs']:.2e} (limit {DENSE_REPLAY_RTOL:g}), "
          f"step counts equal: {d['steps_equal']}")
    if not (d["inputs"] <= DENSE_REPLAY_RTOL and d["results"] <= DENSE_REPLAY_RTOL
            and d["err_norm"] <= DENSE_ERR_NORM_RTOL and d["flips"] == 0
            and d["outputs"] <= DENSE_REPLAY_RTOL and d["steps_equal"]):
        fail("dense output on the card disagrees with the host CPU's arithmetic")
    ctrl_h = Controls(ts=ctrl64.ts.cpu(), signals={k: v.cpu() for k, v in ctrl64.signals.items()})
    free, traces = zip(*(dense_trace(lambda: batched_forward(
        to_host(p64), y64.cpu() * (1.0 + eps), ts64.cpu(), ctrl_h, cfg_d, return_stats=True))
        for eps in (0.0, 1e-15)))
    same = lambda a, b: int(((a.n_accepted == b.n_accepted)  # noqa: E731
                             & (a.n_rejected == b.n_rejected)).sum())
    d["free_device_vs_host"] = rel_err(free[0][0], d["ys"].cpu())
    d["free_host_vs_nudged_host"] = rel_err(free[0][0], free[1][0])
    print(f"adaptive (c): dense in f64, free runs (printed, not held): {device.type} vs host CPU "
          f"_rel_err {d['free_device_vs_host']:.2e}, "
          f"{same(free[0][1], _host_stats(d['stats']))} of {REF_SAMPLES} windows with equal step "
          f"counts; host CPU vs host CPU with y0 x (1 + 1e-15) "
          f"{d['free_host_vs_nudged_host']:.2e}, "
          f"{same(free[0][1], free[1][1])} of {REF_SAMPLES}")
    for label, a, b in ((f"{device.type} vs host CPU", d["trace"], traces[0]),
                        ("host CPU vs host CPU with y0 x (1 + 1e-15)", traces[0], traces[1])):
        d[f"divergence {label}"] = first = divergence(a, b)
        print(f"adaptive (c): dense free runs, {label}: first trial step at which h differs "
              f"by more than " + ", ".join(f"{k}: {v}" for k, v in first.items() if k != "accept")
              + f"; first at which an accept differs: {first['accept']}")
    del d["ys"], d["stats"], d["trace"]
    cohort["dense"]["f64_step_by_step"] = d
    out["cohort"] = cohort

    # (d) backsolve against the discrete adjoint on 256 windows
    (worst_ode, name, gd, gb), worst_nn, grad_s = backsolve_vs_discrete(params, config, batch, ctrl,
                                                                        slice(0, 256))
    print(f"adaptive (d): backsolve vs discrete scan gradients of one MSE on 256 windows: ODE "
          f"parameters worst |b-d|/(1e-8+1e-3|d|)={worst_ode:.3f} (limit 1; {name}: d={gd:.6e} "
          f"b={gb:.6e}); MLP leaves worst _rel_err {worst_nn:.2e} (limit {BACKSOLVE_NN_RTOL}); "
          f"{grad_s['discrete']:.2f} s discrete, {grad_s['backsolve']:.2f} s backsolve")
    if not worst_ode <= 1.0:
        fail("backsolve ODE-parameter gradients disagree with the discrete adjoint")
    if not worst_nn <= BACKSOLVE_NN_RTOL:
        fail("backsolve MLP gradients disagree with the discrete adjoint")
    out["backsolve"] = {"worst_ode": worst_ode, "worst_ode_param": [name, gd, gb],
                        "worst_nn": worst_nn, "seconds": grad_s}

    # (e) one scan-mode dopri5 train step at the cohort shape
    train_batch = dict(batch, external_inputs=dict(ctrl.signals),
                       mask=torch.ones(ts.shape, device=device),
                       loss_weights=torch.as_tensor(ds.loss_weights, device=device))
    step = train_step_fn(state["params"], train_batch, config, cfg["training"]["lambda2"],
                         device)
    step_ms = time_ms(step, 1, ADAPTIVE_STEP_REPS)
    print(f"adaptive (e) ({smi}): dopri5 scan train step at B={n} T={ts.shape[1]} "
          f"H={config.nn_hidden}: {step_ms:.1f} ms (median of {ADAPTIVE_STEP_REPS} after one "
          f"untimed)")
    out["train_step_ms"] = step_ms
    return out


def expected_bwd_sizes(B, in_pad, H, L, substeps, tile):
    """The hand adjoint's launch sizes from its formulas: (tiles, scratch floats
    per block, partials floats per block). Per stage a block saves in_pad +
    L*H rows of inputs and L*H + 8 rows of output cotangents, `tile` floats
    each, and one ReLU-mask word per thread tile (rows of 8 when that gives
    all 256 threads a tile, else of 4, by tile / 4 sample quads) and layer."""
    stages = 4 * substeps
    rt = 8 if (H // 8) * (tile // 4) >= 256 else 4
    mask_words = -(-H // rt) * (tile // 4)
    scratch = stages * tile * ((in_pad + L * H) + (L * H + 8)) + stages * L * mask_words
    partials = in_pad * H + (L - 1) * H * H + H * 8 + L * H + 8
    return -(-B // tile), scratch, partials


def expected_vjp_sizes(B, C, in_pad, H, L, substeps, schedule, tile):
    """The second-derivation adjoint's launch sizes from its formulas: (tiles,
    scratch floats per block, partials floats per block, shared-memory bytes
    per block, staged). Shared memory holds, `tile` floats per row, the
    features (in_pad rows), two hidden buffers (H and max(H, in_pad) rows), the
    residual (8), the 17 effective parameters and their cotangents, the
    context cotangents (C) and, for 'recompute', 6 rows of substep input state
    per substep; then a 32-float parameter row; then two buffers. They hold a
    layer of weights each (the largest) when that fits (staged); otherwise
    what is left, at most the weight cotangents' widest layer pair in chunks
    of 32 columns padded to 36. A stage slot of scratch holds in_pad + 2 L H + 8
    rows; 'recompute' keeps 4 slots, 'chained' 4 per substep."""
    recompute = schedule == "recompute"
    hb = max(H, in_pad)
    acts = 4 * (tile * (in_pad + H + hb + 8 + 2 * 17 + C + (6 * substeps if recompute else 0))
                + 32)
    kn = hb + H  # the contraction's widest pair of layer sides
    want = max(in_pad * H, 8 * H, H * H if L > 1 else 0, 8 * kn)
    staged = acts + 8 * want <= SMEM_LIMIT
    cap = want if staged else min((SMEM_LIMIT - acts) // 8 // 4 * 4, 36 * kn)
    if acts >= SMEM_LIMIT or cap < 8 * kn:
        raise ValueError(f"widths C={C} in_pad={in_pad} H={H} do not fit a block")
    slot = tile * (in_pad + 2 * L * H + 8)
    partials = in_pad * H + (L - 1) * H * H + H * 8 + L * H + 8
    return (-(-B // tile), (4 if recompute else 4 * substeps) * slot, partials,
            acts + 8 * cap, staged)


def cohort_multipliers(n):
    """Per-subject baseline multipliers 1 + cv * N(0, 1), drawn with numpy."""
    from hybrid_ode_torch.data.fourgi_gen import BASELINE_CVS

    rng = np.random.default_rng(COHORT_MULT_SEED)
    return {name: (1.0 + cv * rng.standard_normal(n)).astype(np.float32)
            for name, cv in BASELINE_CVS.items()}


def _row(metrics, preds, test_ds):
    return (metrics["rmse"], metrics["rmse_glucose"], metrics["nll"], metrics["coverage_90"],
            glucose_truth_rmse(preds, test_ds, str(DATA)))


def ensemble_phase(device, smi):
    """Phase 4e: the 4GI generator, the native loader and the identified deep
    ensemble on `device`; returns the report's entries. Fails on any check."""
    from hybrid_ode_torch.data import dataset as data_mod
    from hybrid_ode_torch.data.dataset import pad_batch
    from hybrid_ode_torch.data.fourgi_gen import generate_4gi_dataset, simulate_cohort
    from hybrid_ode_torch.parallel import ensemble

    out = {}
    # (a) the generator: a 50-subject cohort against JAX, an 8192-subject one timed
    mults = cohort_multipliers(COHORT_SUBJECTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_hours, conc, stats = simulate_cohort(None, COHORT_SUBJECTS, multipliers=mults,
                                           device=device, return_stats=True)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    sums = {k: float(v.double().sum()) for k, v in conc.items()}
    rels = {k: abs(sums[k] - ref) / abs(ref) for k, ref in REF_COHORT_SUMS.items()}
    worst = max(rels, key=rels.get)
    print(f"ensemble (a) ({smi}): simulate_cohort {COHORT_SUBJECTS} subjects in {gen_ms:.1f} ms "
          f"(first call); accepted {float(stats.n_accepted.double().mean()):.2f} rejected "
          f"{float(stats.n_rejected.double().mean()):.2f} per subject, success "
          f"{float(stats.success.double().mean()):.3f}; channel sums vs JAX-CPU: "
          + ", ".join(f"{k} {rels[k]:.2e}" for k in rels) + f" (limit {COHORT_SUM_RTOL})")
    if (rels[worst] > COHORT_SUM_RTOL or conc["glucose"].device.type != device.type
            or not all(torch.isfinite(v).all() for v in conc.values())):
        fail(f"simulate_cohort: {worst} sum disagrees with the JAX reference")
    big = cohort_multipliers(COHORT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, big_conc, big_stats = simulate_cohort(None, COHORT, multipliers=big, device=device,
                                             return_stats=True)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.isfinite(v).all() for v in big_conc.values()):
        fail("the 8192-subject cohort is not finite")
    print(f"ensemble (a) ({smi}): simulate_cohort {COHORT} subjects in {big_ms:.1f} ms; accepted "
          f"{float(big_stats.n_accepted.double().mean()):.2f} rejected "
          f"{float(big_stats.n_rejected.double().mean()):.2f} per subject")
    out["generator"] = {"ms_50": gen_ms, "ms_8192": big_ms, "sums": sums, "rel_err": rels,
                        "accepted": float(stats.n_accepted.double().mean()),
                        "rejected": float(stats.n_rejected.double().mean()),
                        "success": float(stats.success.double().mean())}

    # (b) the cohort's CSV back through the native and the csv route
    rng = np.random.default_rng(COHORT_MULT_SEED + 1)
    noise = {name: rng.standard_normal((COHORT_SUBJECTS, len(t_hours))).astype(np.float32)
             for name in conc}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "cohort.csv")
        t0 = time.perf_counter()
        generate_4gi_dataset(path, n_subjects=COHORT_SUBJECTS, multipliers=mults, noise=noise,
                             device=device)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = create_data_arrays(path, 61, 30)
        native_route, native_s = data_mod.last_route, time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = create_data_arrays(path, 61, 30, use_native=False)
        plain_route, plain_s = data_mod.last_route, time.perf_counter() - t0
    unequal = [f.name for f in dataclasses.fields(native)
               if not np.array_equal(getattr(native, f.name), getattr(plain, f.name))]
    print(f"ensemble (b): generate_4gi_dataset wrote {COHORT_SUBJECTS} subjects in {write_s:.2f} s; "
          f"read back by the {native_route} route in {native_s:.3f} s and the {plain_route} "
          f"route in {plain_s:.3f} s: {len(native)} windows, "
          + ("bitwise equal" if not unequal else f"unequal in {unequal}"))
    if native_route != "native" or plain_route != "csv" or unequal:
        fail("the native and the csv route disagree on the generated cohort")
    out["loader"] = {"native_s": native_s, "csv_s": plain_s, "write_s": write_s,
                     "windows": len(native)}

    # (c) the checkpoint at full width, the plain ensemble
    ds = create_data_arrays(str(DATA), 61, 30, use_native=False)
    train_ds, _, test_ds = split_dataset(ds, seed=42)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_plain, arrays = evaluate_checkpoint(str(ENSEMBLE_CKPT), test_ds, device=device,
                                          return_arrays=True)
    plain_s = time.perf_counter() - t0
    names = ("rmse", "rmse_glucose", "nll", "coverage_90", "glucose_vs_truth")
    held = ("rmse", "rmse_glucose", "glucose_vs_truth")

    def check(label, row, ref):
        rels = {n: abs(g - r) / abs(r) for n, g, r in zip(names, row, ref)}
        print(f"ensemble {label}: " + ", ".join(
            f"{n}={g:.8f} (JAX-CPU {r}, rel_err {rels[n]:.2e})" for n, g, r in zip(names, row, ref))
            + f"; held: {', '.join(held)} (limit {REF_RTOL})")
        if any(rels[n] > REF_RTOL for n in held):
            fail(f"ensemble {label}: a held metric disagrees with the JAX reference")
        return rels

    row = _row(m_plain, arrays[0], test_ds)
    rel_plain = check(f"(c) plain, evaluate_checkpoint in {plain_s:.2f} s", row, REF_ENSEMBLE_PLAIN)
    out["plain"] = {"row": row, "rel_err": rel_plain, "seconds": plain_s,
                    "checkpoint_val_loss": m_plain["checkpoint_val_loss"]}

    # (d) the identified ensemble; each identification step (forward, the
    # intervals' recompute, backward, Adam on the codes) ends in an Adam update,
    # stamped on the host clock after a synchronize
    stamps = []
    adam_step = _Adam.step

    def stamped(self, grads):
        adam_step(self, grads)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _Adam.step = stamped
    try:
        t0 = time.perf_counter()
        m_id, arrays = evaluate_checkpoint(str(ENSEMBLE_CKPT), test_ds, device=device,
                                           return_arrays=True, identify_steps=ENSEMBLE_ID_STEPS,
                                           identify_points=ENSEMBLE_ID_POINTS)
        id_s = time.perf_counter() - t0
    finally:
        _Adam.step = adam_step
    row = _row(m_id, arrays[0], test_ds)
    rel_id = check(f"(d) {ENSEMBLE_ID_STEPS} identification steps at {ENSEMBLE_ID_POINTS} points, "
                   f"evaluate_checkpoint in {id_s:.2f} s", row, REF_ENSEMBLE_IDENTIFIED)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    id_step_ms = statistics.median(step_ms)
    print(f"ensemble (d) ({smi}): identification at K=8 B={len(test_ds)} {ENSEMBLE_ID_POINTS} "
          f"points: {id_step_ms:.1f} host ms per step (median of {len(step_ms)}: "
          + ", ".join(f"{x:.1f}" for x in step_ms) + ")")
    state, meta = load_checkpoint(str(ENSEMBLE_CKPT))
    stacked = params_from_numpy(state, device)
    config = config_from_dict(meta["config"], use_pallas=False)
    test_batch = pad_batch(test_ds.batch(np.arange(len(test_ds))), len(test_ds))[0]
    out["identified"] = {"row": row, "rel_err": rel_id, "seconds": id_s,
                         "step_ms": id_step_ms, "steps_ms": step_ms}

    # (e) one ensemble train step of the recipe, then 2 timed
    rc = ENSEMBLE_RECIPE
    first = next(batch_iterator(train_ds, rc["batch_size"], shuffle=True, seed=rc["seed"]))
    batch = batch_to_tensors(pad_batch(first, rc["batch_size"])[0], device)
    opt = ensemble.make_ensemble_optimizer(rc["learning_rate"], rc["epochs"], 1,
                                           rc["gradient_clip"], train_ode_params=True)
    st = ensemble.init_ensemble_state(opt, stacked)
    step = ensemble.make_ensemble_train_step(opt, config, rc["lambda1"], rc["lambda2"], False)
    gens = [torch.Generator().manual_seed(i) for i in range(8)]
    st, met = step(st, batch, gens)
    losses, gnorms = met["loss"].cpu().numpy(), met["grad_norm"].cpu().numpy()
    rel_loss = float(np.abs(losses - REF_ENSEMBLE_STEP_LOSS).max()
                     / np.abs(REF_ENSEMBLE_STEP_LOSS).max())
    rel_gn = float(np.abs(gnorms - REF_ENSEMBLE_STEP_GRAD_NORM).max()
                   / np.abs(REF_ENSEMBLE_STEP_GRAD_NORM).max())
    step_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m2 = step(st, batch, gens)
        float(m2["loss"].sum())
        step_times.append((time.perf_counter() - t0) * 1e3)
    print(f"ensemble (e) ({smi}): train step at K=8 B={rc['batch_size']} T=61 H=128: member "
          f"losses {np.round(losses, 8).tolist()} (rel_err {rel_loss:.2e}), grad norms "
          f"{np.round(gnorms, 7).tolist()} (rel_err {rel_gn:.2e}; limit {REF_RTOL}); all "
          f"updated {bool(met['update_ok'].all())}; next 2 steps {step_times[0]:.1f}, "
          f"{step_times[1]:.1f} host ms")
    if rel_loss > REF_RTOL or rel_gn > REF_RTOL or not bool(met["update_ok"].all()):
        fail("the ensemble train step disagrees with the JAX reference")
    out["train_step"] = {"losses": losses.tolist(), "grad_norms": gnorms.tolist(),
                         "rel_err_loss": rel_loss, "rel_err_grad_norm": rel_gn,
                         "ms": step_times}

    # (f) launches of one forward at K=1 and at K=8 (the test windows' first 13
    # points): the members run in one pass
    short = dict(test_batch, observations=test_batch["observations"][:, :13],
                 time_points=test_batch["time_points"][:, :13], mask=test_batch["mask"][:, :13],
                 external_inputs={k: v[:, :13] for k, v in test_batch["external_inputs"].items()})
    one = {g: {n: v[:1] for n, v in grp.items()} for g, grp in stacked.items()}
    prof = {}
    for label, params in (("K=1", one), ("K=8", stacked)):
        with torch.no_grad():
            wall_ms, kernels = profile_ms(lambda: ensemble.ensemble_forward(params, short, config))
        prof[label] = {"wall_ms": wall_ms, "launches": sum(n for _, n in kernels.values()),
                       "busy_ms": sum(ms for ms, _ in kernels.values())}
    a, b = prof["K=1"]["launches"], prof["K=8"]["launches"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ensemble.ensemble_forward(stacked, test_batch, config)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    print(f"ensemble (f) ({smi}): one forward over 12 intervals: K=1 {a} launches, wall "
          f"{prof['K=1']['wall_ms']:.1f} ms, device busy {prof['K=1']['busy_ms']:.1f} ms; K=8 {b} "
          f"launches, wall {prof['K=8']['wall_ms']:.1f} ms, device busy "
          f"{prof['K=8']['busy_ms']:.1f} ms ({100 * prof['K=8']['busy_ms'] / prof['K=8']['wall_ms']:.1f}%)"
          f"; one K=8 forward over all 60 intervals {fwd_ms:.1f} host ms")
    if a < 100 or abs(b - a) > 0.05 * a:
        fail("the ensemble forward's launches grow with the member count")
    out["launches"] = dict(prof, forward_ms=fwd_ms)
    return out


def _rel_to(ref, x):
    """max |x - ref| / (1 + |ref|): the JAX suite's fused-vs-XLA measure."""
    ref, x = ref.double(), x.double()
    return float(((x - ref).abs() / (1.0 + ref.abs())).max())


def _recording(logp_and_grad, calls):
    def f(q):
        v, g = logp_and_grad(q)
        calls.append((v, g))
        return v, g
    return f


def bayes_phase(device, smi, chains=NUTS_CHAINS, cmp_chains=NUTS_CMP_CHAINS,
                gauss_chains=NUTS_CHAINS, vi_samples=VI_EVAL_SAMPLES):
    """Phase 4f: Bayesian inference on `device`. The fused NUTS engine's
    kernels in 'abs' mode with 7 rows against their plain versions, the
    engine against the generic one, the sampler on a Gaussian, run_nuts
    through the fused kernels (its launches counted from 0: the phase's main
    path), then VI on the dopri5 recipe. Returns the report's entries; fails
    on any check."""
    from hybrid_ode_torch.data.dataset import pad_batch
    from hybrid_ode_torch.evals.evaluate import evaluate_model
    from hybrid_ode_torch.inference import mcmc
    from hybrid_ode_torch.inference.vi import VariationalInference

    t_phase = time.perf_counter()
    out = {}
    state, meta = load_checkpoint(str(NUTS_CKPT))
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(meta["config"])
    if ((config.solver, config.activation, config.nn_hidden, config.substeps, config.context_points)
            != ("rk4", "relu", 128, SUBSTEPS, 0) or "norm" in params):
        fail(f"{NUTS_CKPT} is not the rk4 / relu / H=128 model without context the phase needs")
    norm = (np.asarray(meta["state_mean"], np.float32), np.asarray(meta["state_std"], np.float32))
    ds = create_data_arrays(str(DATA), 61, 30, norm_stats=norm, use_native=False)
    batch = batch_to_tensors(ds.batch(np.arange(NUTS_WINDOWS)), device)
    B, T = batch["time_points"].shape
    fused = mcmc.posterior(params, batch, config, "fused")
    generic = mcmc.posterior(params, batch, config, "xla")
    dim = fused.layout.dim
    q_idx = [int(fused.layout.index(n)) for n in fused.sample_names]
    cpi = tuple(fused_rk4.PARAM_ORDER.index(n[4:]) for n in fused.sample_names)
    # chain starts as run_nuts draws them: the checkpoint's values + 0.01 N(0, 1)
    rng = np.random.default_rng(12)
    Q = fused.q0[None] + 0.01 * torch.as_tensor(rng.standard_normal((chains, dim)),
                                                 dtype=torch.float32, device=device)
    print(f"bayes: {NUTS_CKPT.parent.name}, {B} windows x T={T}, {chains} chains = "
          f"{chains * B} lanes, {len(cpi)} sampled parameters as 'abs' context rows "
          f"(PARAM_ORDER {cpi})")

    # (a) both kernels in 'abs' mode with 7 rows at the engine's full lane count
    sig = fused.controls.signals
    rep = lambda x: x.repeat(chains, 1)  # noqa: E731  chain-major lanes c * B + b
    packed = fused_rk4.pack(rep(batch["initial_state"]), rep(batch["time_points"]),
                            rep(sig["meal"]), rep(sig["tVNS"]), params["ode"], params["nn"],
                            config.nn_layers, Q[:, q_idx].repeat_interleave(B, 0))
    with torch.no_grad():
        k = fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS, cpi, "abs")
        torch.cuda.synchronize()
        fwd_err = compare(k, fused_rk4._fwd_plain(*packed, SUBSTEPS, cpi, "abs"),
                          f"'abs' 7 rows at {chains * B} lanes")
    nb = min(BWD_B, chains * B)
    packed_head = (packed[0][:nb].contiguous(), *(x[:, :nb].contiguous() for x in packed[1:5]),
                   packed[5], packed[6])
    bwd_err, _, leaves, _ = compare_bwd(packed_head, T, SUBSTEPS,
                                        f"'abs' 7 rows (first {nb} lanes)", cpi, "abs",
                                        limit=BWD_FULL_RTOL)
    if tuple(leaves["dctx"].shape) != (nb, len(cpi)):
        fail(f"the hand adjoint's dctx is {tuple(leaves['dctx'].shape)}, not ({nb}, 7)")
    out["kernels_abs7"] = {"fwd_max_abs": fwd_err, "bwd_max_abs": bwd_err}

    # (b) + (c): the first transition of cmp_chains chains through both engines
    # on identical draws; its first evaluation is (b)
    Qc = Q[:cmp_chains]
    eps = torch.logspace(-4, -2, cmp_chains, device=device)
    ones = torch.ones(dim, device=device)
    res, first = {}, {}
    for name, post in (("fused", fused), ("generic", generic)):
        calls = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = mcmc._nuts_step(_recording(post.logp_and_grad, calls), Qc,
                                    mcmc.TorchDraws(torch.Generator(device).manual_seed(21)),
                                    eps, ones, NUTS_CMP_DEPTH)
        torch.cuda.synchronize()
        first[name] = calls[0]
        print(f"bayes (c): one transition of {cmp_chains} chains at depth {NUTS_CMP_DEPTH}, "
              f"{name} engine: {len(calls)} evaluations in {time.perf_counter() - t0:.2f} s")
    f64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x  # noqa: E731
    b64 = {k: ({n: f64(v) for n, v in x.items()} if isinstance(x, dict) else f64(x))
           for k, x in batch.items()}
    p64 = {g: {n: f64(v) for n, v in grp.items()} for g, grp in params.items()}
    t0 = time.perf_counter()
    v64, g64 = mcmc.posterior(p64, b64, config, "xla").logp_and_grad(Qc.double())
    f64_s = time.perf_counter() - t0
    v_err = _rel_to(first["generic"][0], first["fused"][0])
    g_jax = _rel_to(first["generic"][1], first["fused"][1])
    def col_err(x):  # _rel_err of each parameter's gradient over the chains
        return ((x.double() - g64).abs().amax(0) / g64.abs().amax(0).clamp_min(1e-8)).tolist()

    err_f, err_g = col_err(first["fused"][1]), col_err(first["generic"][1])
    g_ok = all(f <= BWD_FULL_RTOL or f <= g for f, g in zip(err_f, err_g))
    print(f"bayes (b): fused chain log-posterior vs generic engine at {cmp_chains} chains: value "
          f"{v_err:.2e} (max |d| / (1 + |v|), limit {NUTS_CMP_RTOL}); gradient {g_jax:.2e} by "
          f"that measure (not held); per parameter _rel_err against the generic engine in f64 "
          f"({f64_s:.1f} s), fused / generic f32: "
          + ", ".join(f"{n[4:]} {f:.2e} / {g:.2e}" for n, f, g in
                      zip(fused.sample_names, err_f, err_g))
          + f" (limit {BWD_FULL_RTOL}, or no farther than the generic f32): {'ok' if g_ok else 'FAIL'}")
    if not (v_err <= NUTS_CMP_RTOL and g_ok):
        fail("the fused chain log-posterior disagrees with the generic engine")
    qf, af, nf, df = res["fused"]
    qg, ag, ng, dg = res["generic"]
    agree = (nf == ng) & (df == dg) & ((qf - qg).abs() <= 1e-4 * qg.abs()).all(-1)
    n_agree = int(agree.sum())
    print(f"bayes (c): chains agreeing on n_leapfrog with q within 1e-4: {n_agree} of "
          f"{cmp_chains} (expected >= {cmp_chains - 3}); n_leapfrog fused "
          f"{nf.tolist()[:16]}..., accept statistic max |d| {float((af - ag).abs().max()):.2e}")
    if n_agree < cmp_chains - 3:
        fail("the fused and the generic engine took other transitions on the same draws")
    out["engines"] = {"logp_err": v_err, "grad_err_jax": g_jax, "fused_vs_f64": err_f,
                      "generic_vs_f64": err_g, "agree": n_agree,
                      "chains": cmp_chains}

    # (d) the sampler alone on a correlated 7-d Gaussian
    g_rng = np.random.default_rng(13)
    Amat = g_rng.normal(size=(GAUSS_DIM, GAUSS_DIM))
    cov = Amat @ Amat.T / GAUSS_DIM + 0.3 * np.eye(GAUSS_DIM)
    mu = g_rng.normal(size=GAUSS_DIM)
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device=device)
    mu_t = torch.as_tensor(mu, dtype=torch.float32, device=device)

    def gauss_logp(q):
        d = q - mu_t
        return -0.5 * ((d @ prec) * d).sum(-1)

    gen = torch.Generator(device).manual_seed(14)
    syncs0 = mcmc.host_syncs
    t0 = time.perf_counter()
    g_out = mcmc.nuts_sample(gauss_logp, torch.randn((gauss_chains, GAUSS_DIM), generator=gen,
                                                     device=device), gen,
                             num_samples=GAUSS_SAMPLES, num_warmup=GAUSS_WARMUP,
                             max_depth=GAUSS_DEPTH)
    g_s = time.perf_counter() - t0
    draws = g_out["samples"].reshape(-1, GAUSS_DIM).astype(np.float64)
    mean_err = float(np.abs(draws.mean(0) - mu).max())
    cov_err = float(np.abs(np.cov(draws.T) - cov).max())
    div_rate = float(g_out["diverging"].mean())
    leap = int(g_out["n_leapfrog"].sum())
    print(f"bayes (d) ({smi}): nuts_sample, correlated {GAUSS_DIM}-d Gaussian, {gauss_chains} "
          f"chains x ({GAUSS_WARMUP} warmup + {GAUSS_SAMPLES} draws), depth {GAUSS_DEPTH}, in "
          f"{g_s:.2f} s ({mcmc.host_syncs - syncs0} loop iterations): mean err {mean_err:.3f} "
          f"(atol {GAUSS_MEAN_ATOL}), cov err {cov_err:.3f} (atol {GAUSS_COV_ATOL}), divergence "
          f"rate {div_rate:.4f} (< {GAUSS_DIV_RATE}), {leap / g_out['n_leapfrog'].size:.1f} "
          "leapfrogs per draw")
    if not (mean_err <= GAUSS_MEAN_ATOL and cov_err <= GAUSS_COV_ATOL and div_rate < GAUSS_DIV_RATE):
        fail("nuts_sample missed the Gaussian's moments or diverged too often")
    out["gaussian"] = {"mean_err": mean_err, "cov_err": cov_err, "divergence_rate": div_rate,
                       "seconds": g_s}

    # (e) the phase's main path: run_nuts through the fused kernels, every
    # count from 0
    with torch.no_grad():
        pair_ms = time_ms(lambda: fused.logp_and_grad(Q), 1, 3)
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    fused_rk4.fused_rk4_bwd_vjp_launches = 0
    mcmc.host_syncs = mcmc.grad_evals = mcmc.transitions = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = mcmc.run_nuts(params, batch, config, torch.Generator(device).manual_seed(0),
                            num_samples=NUTS_SAMPLES, num_warmup=NUTS_WARMUP, n_chains=chains,
                            max_depth=NUTS_DEPTH, engine="fused")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches,
                fused_rk4.fused_rk4_bwd_vjp_launches)
    evals, trans, syncs = mcmc.grad_evals, mcmc.transitions, mcmc.host_syncs
    leapfrogs = evals - trans
    accept = float(np.mean(samples["_accept_stat"]))
    finite = all(np.isfinite(v).all() for v in samples.values())
    print(f"main path (NUTS, fused engine): run_nuts {chains} chains x ({NUTS_WARMUP} warmup + "
          f"{NUTS_SAMPLES} draws), depth {NUTS_DEPTH}, in {run_s:.2f} s: {trans} transitions, "
          f"{leapfrogs} leapfrogs, fused_rk4_fwd launches={launches[0]} fused_rk4_bwd "
          f"launches={launches[1]} (leapfrogs + initial gradients = {evals}); mean accept "
          f"statistic {accept:.3f} (> 0.2); divergences {int(samples['_diverging'].sum())} of "
          f"{samples['_diverging'].size}; every draw finite: {finite}")
    if not finite or not accept > 0.2:
        fail("run_nuts(engine='fused') gave non-finite draws or accepted too little")
    if not launches[0] == launches[1] == evals or launches[2]:
        fail("the fused engine's launches are not one forward and one hand adjoint per evaluation")
    diag = {}
    for n in fused.sample_names:
        s_cd = samples[n].reshape(chains, NUTS_SAMPLES)
        diag[n] = (mcmc.rhat(s_cd), mcmc.ess_bulk(s_cd), mcmc.ess_tail(s_cd))
    print("bayes (e): split R-hat / bulk ESS / tail ESS (not held: a short run): "
          + "; ".join(f"{n[4:]} {r:.3f} / {b:.0f} / {t:.0f}" for n, (r, b, t) in diag.items()))
    host_ms = (run_s * 1e3 - evals * pair_ms) / max(leapfrogs, 1)
    wall_ms, kernels = profile_ms(lambda: mcmc._nuts_step(  # the kernels are warm
        fused.logp_and_grad, Q, mcmc.TorchDraws(torch.Generator(device).manual_seed(5)),
        torch.as_tensor(samples["_step_size"], device=device), torch.ones(dim, device=device),
        NUTS_DEPTH), warm=False)
    busy_ms = sum(ms for ms, _ in kernels.values())
    print(f"bayes (e) ({smi}): fused leapfrog pair (forward + hand adjoint + host work) "
          f"{pair_ms:.3f} ms at {chains * B} lanes; host bookkeeping {host_ms:.3f} ms per "
          f"leapfrog; {leapfrogs / run_s:.2f} leapfrogs/s, {trans / run_s:.3f} transitions/s, "
          f"{chains * NUTS_SAMPLES / run_s:.1f} draws/s (warmup included); "
          f"{syncs / trans:.1f} host syncs per transition; one profiled transition: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    out["nuts"] = {"seconds": run_s, "transitions": trans, "leapfrogs": leapfrogs,
                   "grad_evals": evals, "launches": launches, "accept": accept,
                   "divergences": int(samples["_diverging"].sum()), "diagnostics": diag,
                   "pair_ms": pair_ms, "host_ms_per_leapfrog": host_ms,
                   "host_syncs": syncs, "profile": {"wall_ms": wall_ms, "busy_ms": busy_ms}}

    # (f) VI on the 4gi_vi.yaml recipe (dopri5: the plain solvers, no fused launch)
    before = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches,
              fused_rk4.fused_rk4_bwd_vjp_launches)
    vstate, vmeta = load_checkpoint(str(VI_CKPT))
    vconfig = config_from_dict(vmeta["config"])
    vds = create_data_arrays(str(DATA), 61, 30, use_native=False)
    train_ds, _, test_ds = split_dataset(vds, seed=42)
    vbatch = pad_batch(next(batch_iterator(train_ds, VI_BATCH, shuffle=True, seed=0)), VI_BATCH)[0]
    vi = VariationalInference(params_from_numpy(vstate["params"], device), vconfig,
                              prior_params=VI_PRIORS, learning_rate=VI_LR, **VI_SETTINGS)
    t0 = time.perf_counter()
    _, comps = vi.evaluate_elbo(vbatch, eps={k: torch.tensor(v) for k, v in VI_EPS.items()})
    elbo_s = time.perf_counter() - t0
    for key, ref in (("elbo", REF_VI_ELBO), ("kl", REF_VI_KL), ("log_likelihood", REF_VI_LOGLIK)):
        got = float(comps[key])
        rel = abs(got - ref) / abs(ref)
        print(f"bayes (f): first VI {key}={got:.7f} JAX-CPU reference={ref} rel_err={rel:.2e} "
              f"(limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"the first VI {key} disagrees with the JAX reference")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = vi.train_step(vbatch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    vi_step_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(v) for v in step.values()):
        fail("the VI step's ELBO is not finite")
    with tempfile.TemporaryDirectory() as tmp:
        vi.save_checkpoint(str(Path(tmp) / "vi_model"))
        restored = VariationalInference.restore(str(Path(tmp) / "vi_model"), device=device)

    def vi_metrics(v):
        return evaluate_model(v.template, test_ds, v.config, variational=v,
                              n_posterior_samples=vi_samples, obs_sigma=v.noise_sigma,
                              generator=torch.Generator().manual_seed(3))

    t0 = time.perf_counter()
    m_r = vi_metrics(restored)
    eval_s = time.perf_counter() - t0
    m_v = vi_metrics(vi)
    diff = max(abs(m_r[k] - m_v[k]) / max(abs(m_v[k]), 1e-12) for k in m_v)
    after = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches,
             fused_rk4.fused_rk4_bwd_vjp_launches)
    print(f"bayes (f) ({smi}): ELBO (forward) {elbo_s:.2f} s; one VI step {vi_step_ms:.1f} ms "
          f"(dopri5 scan, {VI_SETTINGS['n_samples']} samples x {VI_BATCH} windows on the member "
          f"axis): {json.dumps(step)}; restored checkpoint, evaluate_model VI branch on "
          f"{len(test_ds)} test windows with {vi_samples} posterior samples in {eval_s:.2f} s: "
          f"rmse {m_r['rmse']:.6f} ece {m_r['ece']:.4f} coverage_90 {m_r['coverage_90']:.4f}; "
          f"restored vs in-memory max rel diff {diff:.2e}; fused launches {before} -> {after}")
    if not all(np.isfinite(v) for v in m_r.values()) or not diff <= 1e-6:
        fail("the restored VI posterior's metrics are not finite or differ from the in-memory one's")
    if after != before:
        fail("the VI recipe (dopri5) launched a fused kernel")
    out["vi"] = {"elbo": float(comps["elbo"]), "kl": float(comps["kl"]),
                 "log_likelihood": float(comps["log_likelihood"]), "step_ms": vi_step_ms,
                 "elbo_s": elbo_s, "eval_s": eval_s, "restored_diff": diff,
                 "metrics": {k: m_r[k] for k in ("rmse", "ece", "coverage_90", "nll")}}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"bayes: phase 4f in {out['seconds']:.1f} s")
    return out


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; TF32 off")
    report = {"device": kind, "nvidia_smi": smi}

    # 2. build
    t0 = time.perf_counter()
    built = fused_rk4.build_library()
    fused_rk4._libraries()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for stem, (so, log) in built.items():
        ptxas[stem] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"build: {so.name}: " + " | ".join(ptxas[stem]))
    print(f"build: {len(built)} libraries in {build_s:.1f} s")
    report.update(build_s=build_s, ptxas=ptxas)
    tile = fused_rk4.fwd_tile()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_shapes = 0
    for B in (1, 2, tile - 1, tile + 1, 1000, COHORT, 40000):
        for C, in_pad, H, L, substeps in ((0, 16, 64, 2, 2), (16, 32, 128, 4, 4), (3, 16, 128, 4, 1),
                                          (0, 16, 200, 2, 2), (5, 16, 132, 3, 3), (0, 16, 8, 1, 1)):
            got = fused_rk4.bwd_sizes(B, C, in_pad, H, L, substeps)
            tiles, *want = expected_bwd_sizes(B, in_pad, H, L, substeps, got.tile)
            # one block per tile, or every SM's resident blocks when there are more tiles
            grid_ok = got.grid == tiles or (got.grid < tiles and got.grid % sms == 0)
            if got.tile != tile or not grid_ok or [got.scratch, got.partials] != want:
                fail(f"adjoint sizes for B={B} C={C} in_pad={in_pad} H={H} L={L} substeps="
                     f"{substeps}: library {got}, formula {tiles} tiles, {want}")
            n_shapes += 1
            for sched in ("recompute", "chained"):
                got = fused_rk4.vjp_sizes(B, C, in_pad, H, L, substeps, sched)
                tiles, *want = expected_vjp_sizes(B, C, in_pad, H, L, substeps, sched, got.tile)
                grid_ok = got.grid == tiles or (got.grid < tiles and got.grid % sms == 0)
                if got.tile != tile or not grid_ok or [got.scratch, got.partials, got.smem,
                                                       got.staged] != want:
                    fail(f"second-derivation sizes for B={B} C={C} in_pad={in_pad} H={H} L={L} "
                         f"substeps={substeps} '{sched}': library {got}, formula {tiles} tiles, "
                         f"{want}")
    print(f"sizes: tile {tile}; both adjoint libraries' grid, scratch, partials (and the second "
          f"derivation's shared memory and route, both schedules) equal the formula's on "
          f"{n_shapes} shapes ({sms} SMs) ok")

    # 3. kernel vs plain
    state, meta = load_checkpoint(str(CKPT))
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(meta["config"], use_pallas=True)
    ds = create_data_arrays(str(DATA), 61, 30, use_native=False)
    batch, ctrl = cohort_inputs(ds, params, config, device)
    sig = ctrl.signals
    packed = fused_rk4.pack(batch["initial_state"], batch["time_points"], sig["meal"],
                            sig["tVNS"], params["ode"], params["nn"], config.nn_layers,
                            sig["context"])
    T = batch["time_points"].shape[1]
    C = sig["context"].shape[1]
    print(f"cohort: B={COHORT} T={T} substeps={SUBSTEPS} H={config.nn_hidden} "
          f"layers={config.nn_layers} context={C} features")
    with torch.no_grad():
        full_kernel = fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS)
        torch.cuda.synchronize()
        full_plain = fused_rk4._fwd_plain(*packed, SUBSTEPS)
    max_abs = {"full": compare(full_kernel, full_plain, "full width")}
    small = {}
    for name, layers, mode in (("layers2", 2, None), ("mul", 4, "mul"), ("abs", 4, "abs")):
        small[name] = small_case(name, params["ode"], device, layers, mode)
        p, idx, m = small[name]
        k = fused_rk4.fused_rk4_fwd(*p, 2, idx, m)
        torch.cuda.synchronize()
        max_abs[name] = compare(k, fused_rk4._fwd_plain(*p, 2, idx, m), f"small {name}")
    # across the tile's edge, one block alone, and the route for widths whose
    # layers do not fit in shared memory
    edge = {f"B{B}": small_case(f"B{B}", params["ode"], device, 4, "mul", B=B)
            for B in (2, tile - 1, tile + 1)}
    edge["wide"] = small_case("wide", params["ode"], device, 2, "mul", B=100, hidden=200)
    for name, (p, idx, m) in edge.items():
        k = fused_rk4.fused_rk4_fwd(*p, 2, idx, m)
        torch.cuda.synchronize()
        max_abs[name] = compare(k, fused_rk4._fwd_plain(*p, 2, idx, m), f"small {name}")
    in_pad, hid = packed[5].in_pad, packed[5].hidden
    routes = {"cohort": fused_rk4.bwd_sizes(COHORT, C, in_pad, hid, config.nn_layers,
                                            SUBSTEPS).staged,
              "wide": fused_rk4.bwd_sizes(100, 3, 16, 200, 2, 2).staged}
    # the second derivation at the cohort's widths (features mode) and at the r2
    # checkpoint's (params mode: 3 context rows, layer 0 takes 9 inputs padded to 16)
    for sched in ("recompute", "chained"):
        for name, args in (("cohort", (C, in_pad)), ("params", (3, 16))):
            got = fused_rk4.vjp_sizes(COHORT, *args, hid, config.nn_layers, SUBSTEPS, sched)
            routes[f"vjp_{sched}_{name}"] = got.staged
            print(f"route: second derivation '{sched}' at the {name} widths: staged "
                  f"{got.staged}, {got.smem} B of shared memory per block")
        routes[f"vjp_{sched}_wide"] = fused_rk4.vjp_sizes(100, 3, 16, 200, 2, 2, sched).staged
    print(f"routes: weights staged through shared memory at the cohort's widths: "
          f"{routes['cohort']}; at H=200: {routes['wide']}; second derivation: "
          + ", ".join(f"{k[4:]} {v}" for k, v in routes.items() if k.startswith("vjp_")))
    if (not all(v for k, v in routes.items() if not k.endswith("wide"))
            or any(v for k, v in routes.items() if k.endswith("wide"))):
        fail("the cohort's widths must take the staged route and H=200 the other")
    report["max_abs_err"] = max_abs

    # 3b. adjoint kernel vs plain
    head = slice(0, BWD_B)
    packed_head = (packed[0][head].contiguous(),
                   *(x[:, head].contiguous() for x in packed[1:5]), packed[5], packed[6])
    full_label = f"full width (first {BWD_B} of the cohort)"
    bwd_abs, bwd_plain_s, _, f64 = compare_bwd(packed_head, T, SUBSTEPS, full_label, full=True)
    bwd_max_abs = {"full": bwd_abs}
    hand_small = {}
    for name, (p, idx, m) in {**small, **edge}.items():
        bwd_max_abs[name], _, hand_small[name], _ = compare_bwd(p, 13, 2, f"small {name}", idx, m)
    # block g owns its slice of the partials and the slices are added in block
    # order: the same inputs must give the same bits
    traj_head, gbar_head = bwd_inputs(packed_head, T, SUBSTEPS)
    twice = [fused_rk4.fused_rk4_bwd(traj_head, gbar_head, *packed_head[1:], SUBSTEPS)
             for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*twice)):
        fail("the hand adjoint gave different outputs on the same inputs")
    print("hand adjoint twice on the same full-width inputs: every output bitwise equal ok")
    report["bwd_max_abs_err"] = bwd_max_abs

    # 3c. second-derivation adjoint kernel vs plain, vs 'hand', probes
    vjp_max_abs, vjp_plain_s = {}, {}
    for impl in ("recompute", "chained"):
        vjp_max_abs[f"full_{impl}"], vjp_plain_s[impl], full_leaves, _ = compare_bwd(
            packed_head, T, SUBSTEPS, full_label, full=True, impl=impl, f64=f64)
        for name, (p, idx, m) in {**small, **edge}.items():
            vjp_max_abs[f"{name}_{impl}"], _, leaves, _ = compare_bwd(
                p, 13, 2, f"small {name}", idx, m, impl=impl)
            if impl == "recompute":
                compare_leaves(hand_small[name], leaves, f"'hand' vs 'recompute' kernels small {name}",
                               BWD_SMALL_RTOL)
            elif name == "mul":
                check_probes(p, 13, 2, "small mul", idx, m, leaves)
            elif name in edge:
                check_probes(p, 13, 2, f"small {name}", idx, m, leaves, ("probe_yw",))
    check_probes(packed_head, T, SUBSTEPS, "full width", (), "mul", full_leaves)
    # per-block slices summed in block order, and 'recompute' reduces the
    # parameter cotangents inside the block: the same inputs, the same bits
    for impl in ("recompute", "chained"):
        twice = [fused_rk4.fused_rk4_bwd_vjp(traj_head, gbar_head, *packed_head[1:], SUBSTEPS,
                                             (), "mul", "f32", impl) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*twice)):
            fail(f"'{impl}' gave different outputs on the same inputs")
        print(f"'{impl}' twice on the same full-width inputs: every output bitwise equal ok")
    report["vjp_max_abs_err"] = vjp_max_abs

    # 3d. mlp_dtype='bf16': the three kernels vs their plain versions
    p, idx, m = small["mul"]
    compare_bf16(p, 13, 2, "small mul", idx, m, BF16_SMALL_RTOL)
    short = (packed_head[0], *(x[:BF16_SHORT_T].contiguous() for x in packed_head[1:4]),
             *packed_head[4:])
    compare_bf16(short, BF16_SHORT_T, SUBSTEPS, f"full width, {BF16_SHORT_T} grid points", (),
                 "mul", BF16_SHORT_RTOL)
    bf16_traj, bf16_err, bf16_unrounded = compare_bf16(packed_head, T, SUBSTEPS, full_label, (),
                                                       "mul", float("inf"))
    bf16_dist = rel_err(full_kernel[:, :, head], bf16_traj)
    print(f"bf16 forward vs f32 forward {full_label}: _rel_err {bf16_dist:.2e}, max abs "
          f"{float((full_kernel[:, :, head] - bf16_traj).abs().max()):.3e}; the bf16 kernel is "
          f"{bf16_err:.2e} from its plain version, the f32 kernel {bf16_unrounded:.2e}")
    report.update(bf16_fwd_kernel_vs_plain=bf16_err, bf16_fwd_vs_f32=bf16_dist,
                  bf16_fwd_f32_kernel_vs_plain=bf16_unrounded)

    # 4. serving path, launch counts from 0
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    train_ds, val_ds, test_ds = split_dataset(ds, seed=42)
    t0 = time.perf_counter()
    metrics = evaluate_checkpoint(str(CKPT), test_ds, val_ds=val_ds, use_pallas=True,
                                  device="cuda")
    eval_s = time.perf_counter() - t0
    with torch.no_grad():
        cohort_ctrl = with_context(params, batch, Controls(
            ts=batch["time_points"], signals={"meal": sig["meal"], "tVNS": sig["tVNS"]}), config)
        traj = batched_forward(params, batch["initial_state"], batch["time_points"],
                               cohort_ctrl, config)
    torch.cuda.synchronize()
    launches = fused_rk4.fused_rk4_fwd_launches
    print(f"main path (serving): evaluate_checkpoint {eval_s:.2f} s, cohort batched_forward "
          f"{tuple(traj.shape)}; fused_rk4_fwd launches={launches}")
    if launches < 1:
        fail("the serving path did not launch the fused RK4 kernel")
    for key, ref in (("rmse", REF_RMSE), ("rmse_glucose", REF_RMSE_GLUCOSE)):
        rel = abs(metrics[key] - ref) / ref
        print(f"metric {key}={metrics[key]:.7f} JAX-CPU reference={ref} rel_err={rel:.2e} "
              f"(limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"{key} disagrees with the JAX reference")
    print("metrics: " + json.dumps({k: round(float(v), 7) for k, v in metrics.items()}))
    if traj.shape != (COHORT, T, 6) or not torch.isfinite(traj).all():
        fail("cohort trajectory has the wrong shape or is not finite")
    compare(traj, full_plain.permute(2, 0, 1), "cohort batched_forward vs plain")
    sub = slice(0, 256)
    with torch.no_grad():
        sub_ctrl = Controls(ts=batch["time_points"][sub], signals={
            k: v[sub] for k, v in cohort_ctrl.signals.items()})
        scan = batched_forward(params, batch["initial_state"][sub], batch["time_points"][sub],
                               sub_ctrl, config_from_dict(meta["config"]))
    compare(traj[sub], scan, "cohort fused vs scan path (first 256)")
    report.update(metrics=metrics, launches=launches, eval_s=eval_s)

    # 4b. training path, launch counts from 0
    cfg = copy.deepcopy(meta["config"])
    cfg["model"]["use_pallas"] = True
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        res = train_model(cfg, train_ds, val_ds, ckpt_dir, None, params=state["params"],
                          max_epochs=3, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches)
        final, final_meta = load_checkpoint(str(Path(ckpt_dir) / "final_model"))
    hist = res.history
    print(f"main path (training): train_model 3 epochs in {train_s:.2f} s, "
          f"{len(hist['step_loss'])} steps; step losses {hist['step_loss']}, grad norms "
          f"{hist['grad_norm']}, val losses {hist['val_loss']}; fused_rk4_fwd launches="
          f"{train_launches[0]} fused_rk4_bwd launches={train_launches[1]}")
    if train_launches[1] < 3:
        fail("the training path launched the backward kernel fewer than 3 times")
    if not all(np.isfinite(hist[k]).all() for k in ("step_loss", "grad_norm", "val_loss")):
        fail("a training loss is not finite")
    leaves = [v for g in final["params"].values() for v in g.values()]
    if (final_meta["epoch"] != 2 or sorted(final["params"]) != sorted(state["params"])
            or not all(np.isfinite(v).all() for v in leaves)):
        fail("final_model did not reload with finite params of the model's structure")
    for key, got, ref in (("loss", hist["step_loss"][0], REF_TRAIN_LOSS),
                          ("grad_norm", hist["grad_norm"][0], REF_GRAD_NORM)):
        rel = abs(got - ref) / ref
        print(f"first train step {key}={got:.9f} JAX-CPU reference={ref} rel_err={rel:.2e} "
              f"(limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"first train step {key} disagrees with the JAX reference")
    # the parameter constructors and train_model from scratch run on the card
    # unless asked otherwise
    fresh = init_hybrid_params(torch.Generator().manual_seed(0), config_from_dict(cfg))
    if not all(v.is_cuda for g in fresh.values() for v in g.values()):
        fail("init_hybrid_params without a device placed a tensor off the card")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        from_scratch = train_model(cfg, train_ds, val_ds, ckpt_dir, None, max_epochs=1)
    if (not all(v.is_cuda for g in from_scratch.params.values() for v in g.values())
            or not np.isfinite(from_scratch.history["step_loss"]).all()):
        fail("train_model from scratch did not train on the card with finite losses")
    print(f"init_hybrid_params(generator, config) without a device: every tensor on the card; "
          f"train_model from scratch, 1 epoch on the default device: step losses "
          f"{from_scratch.history['step_loss']} ok")
    report.update(train_history=hist, train_launches=train_launches, train_s=train_s)

    # 4c. test-time identification through the fused kernels, launch counts from 0
    state2, meta2 = load_checkpoint(str(CKPT_R2))
    params2 = params_from_numpy(state2["params"], device)
    config2 = config_from_dict(meta2["config"])
    if not (config2.use_pallas and config2.context_mode == "params"):
        fail("the r2 checkpoint's config is not use_pallas with context_mode='params'")
    id_batch = batch_to_tensors(next(batch_iterator(test_ds, len(test_ds), shuffle=False)), device)
    k_id = config2.context_points
    with torch.no_grad():
        enc_ctx = encode_context(params2["enc"], id_batch["observations"],
                                 id_batch["time_points"], k_id, config2.activation)
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    fused_rk4.fused_rk4_bwd_vjp_launches = 0
    t0 = time.perf_counter()
    id_ctx = identify_context(params2, id_batch, config2, steps=ID_STEPS)
    torch.cuda.synchronize()
    id_s = time.perf_counter() - t0
    id_launches = [fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches]
    misfits = {"encoder": id_misfit(params2, id_batch, config2, enc_ctx, k_id),
               "identified": id_misfit(params2, id_batch, config2, id_ctx, k_id)}
    print(f"main path (identification): identify_context {ID_STEPS} steps on {len(test_ds)} windows "
          f"x {k_id} points in {id_s:.2f} s; mean misfit encoder {misfits['encoder']:.9f} -> "
          f"identified {misfits['identified']:.9f}; fused_rk4_fwd launches={id_launches[0]} "
          f"fused_rk4_bwd launches={id_launches[1]}")
    if id_launches[0] < ID_STEPS or id_launches[1] < ID_STEPS:
        fail("identification launched the forward or the hand adjoint kernel fewer than ID_STEPS times")
    if not (torch.isfinite(id_ctx).all() and misfits["identified"] <= misfits["encoder"]):
        fail("identification raised the mean misfit above the encoder's")
    for key, ref in (("encoder", REF_ID_MISFIT_ENCODER), ("identified", REF_ID_MISFIT_IDENTIFIED)):
        rel = abs(misfits[key] - ref) / ref
        print(f"identification misfit {key}={misfits[key]:.9f} JAX-CPU reference={ref} "
              f"rel_err={rel:.2e} (limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"identification misfit ({key}) disagrees with the JAX reference")
    # the same gradient with respect to the codes through each adjoint kernel
    idx2 = tuple(fused_rk4.PARAM_ORDER.index(n) for n in config2.context_params)
    dctx = {}
    for impl in ("hand", "recompute", "chained"):
        c = enc_ctx.clone().requires_grad_(True)
        pred = fused_rk4.fused_rk4_hybrid(
            id_batch["initial_state"], id_batch["time_points"][:, :k_id],
            id_batch["external_inputs"]["meal"][:, :k_id],
            id_batch["external_inputs"]["tVNS"][:, :k_id], params2["ode"], params2["nn"],
            substeps=config2.substeps, n_layers=config2.nn_layers, context=c,
            context_param_idx=idx2, bwd_impl=impl)
        (dctx[impl],) = torch.autograd.grad(
            ((pred - id_batch["observations"][:, :k_id]) ** 2).sum(), c)
    torch.cuda.synchronize()
    id_launches.append(fused_rk4.fused_rk4_bwd_vjp_launches)
    for impl in ("recompute", "chained"):
        e = rel_err(dctx["hand"], dctx[impl])
        print(f"identification gradient dctx '{impl}' vs 'hand': _rel_err {e:.2e} (limit 1e-4)")
        if not e <= 1e-4:
            fail(f"dctx of '{impl}' disagrees with 'hand'")
    print(f"identification: fused_rk4_bwd_vjp launches={id_launches[2]}")
    if id_launches[2] < 2:
        fail("the second-derivation adjoint kernel did not launch on the identification path")
    # the rest of the identification functions on the card: per-window
    # parameter multipliers on top of the codes, and the amortised encoder
    sig_k = {n: v[:, :k_id] for n, v in id_batch["external_inputs"].items()}
    ctrl_k = Controls(ts=id_batch["time_points"][:, :k_id], signals=dict(sig_k, context=id_ctx))

    def delta_misfit(deltas):
        with torch.no_grad():
            preds = forward_with_param_deltas(params2, deltas, id_batch["initial_state"],
                                              ctrl_k.ts, ctrl_k, config2)
        se = (preds - id_batch["observations"][:, :k_id]) ** 2 * id_batch["loss_weights"]
        return (se * id_batch["mask"][:, :k_id, None]).sum((1, 2)) / (
            id_batch["mask"][:, :k_id].sum(1) * 6).clamp(min=1.0)

    deltas = identify_params(params2, id_batch, config2, context=id_ctx, steps=5, points=k_id)
    before, after = delta_misfit(torch.zeros_like(deltas)), delta_misfit(deltas)
    all_batch = batch_to_tensors(next(batch_iterator(ds, len(ds), shuffle=False)), device)
    enc, info = amortize_encoder(params2, all_batch, config2, id_steps=5, epochs=20,
                                 finetune_epochs=2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        codes = encode_context(enc, all_batch["observations"], all_batch["time_points"], k_id)
    torch.cuda.synchronize()
    print(f"identification: identify_params 5 steps, per-window misfit {before.tolist()} -> "
          f"{after.tolist()}; amortize_encoder on {len(ds)} windows: " + json.dumps(info))
    if not (torch.isfinite(deltas).all() and (after <= before).all()):
        fail("identify_params returned deltas with a higher misfit than zero deltas")
    if not (np.isfinite(list(info.values())).all() and torch.isfinite(codes).all()
            and codes.shape == (len(ds), len(config2.context_params)) and codes.is_cuda):
        fail("amortize_encoder did not return finite losses and a working encoder on the card")
    report.update(identify={"misfits": misfits, "launches": id_launches, "seconds": id_s,
                            "amortize_info": info})

    # 4d. the adaptive explicit solvers, launch counts from 0: their path runs
    # none of the fused kernels (nor does its JAX counterpart run a Pallas kernel)
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    fused_rk4.fused_rk4_bwd_vjp_launches = 0
    t0 = time.perf_counter()
    report["adaptive"] = adaptive_phase(ds, train_ds, val_ds, test_ds, device, smi)
    adaptive_launches = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches,
                         fused_rk4.fused_rk4_bwd_vjp_launches)
    print(f"adaptive: phase 4d in {time.perf_counter() - t0:.1f} s; fused kernel launches "
          f"{adaptive_launches} (the path runs none); host syncs so far {explicit.host_syncs}")
    if any(adaptive_launches):
        fail("the adaptive path launched a fused RK4 kernel")

    # 4e. the identified deep ensemble and the 4GI generator, launch counts
    # from 0: the JAX ensemble path strips use_pallas, so none of the fused
    # kernels runs here either
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    fused_rk4.fused_rk4_bwd_vjp_launches = 0
    t0 = time.perf_counter()
    report["ensemble"] = ensemble_phase(device, smi)
    ens_launches = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches,
                    fused_rk4.fused_rk4_bwd_vjp_launches)
    report["ensemble"]["seconds"] = time.perf_counter() - t0
    print(f"ensemble: phase 4e in {report['ensemble']['seconds']:.1f} s; fused kernel launches "
          f"{ens_launches} (the path runs none)")
    if any(ens_launches):
        fail("the ensemble path launched a fused RK4 kernel")

    # 4f. Bayesian inference: run_nuts through the fused kernels ('abs' mode,
    # 7 rows, 8192 lanes; its launches counted from 0 inside), then VI on the
    # dopri5 recipe (no fused launch)
    report["bayes"] = bayes_phase(device, smi)
    bayes_launches = report["bayes"]["nuts"]["launches"]

    # 5. timing
    with torch.no_grad():
        traj_full, gbar_full = bwd_inputs(packed, T, SUBSTEPS)
        ms = time_ms(lambda: fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS), 3, 20)
        bwd_ms = time_ms(lambda: fused_rk4.fused_rk4_bwd(traj_full, gbar_full, *packed[1:],
                                                         SUBSTEPS), 2, 20)
        plain_ms = time_ms(lambda: fused_rk4._fwd_plain(*packed, SUBSTEPS), 1, 10)
    nn = params["nn"]
    steps = COHORT * (T - 1) * SUBSTEPS
    fwd_ops, bwd_ops = kernel_ops(nn, config.nn_layers, config.nn_hidden, COHORT, T, SUBSTEPS, C)
    n_w = packed[5].flat.numel()
    in_bytes = 4 * (3 * T * COHORT + C * COHORT + n_w + 32)
    fwd_bytes = in_bytes + 4 * (COHORT * 6 + T * 6 * COHORT)
    bwd_bytes = in_bytes + 4 * (2 * T * 6 * COHORT + COHORT * 6 + n_w + 17 * COHORT + C * COHORT)
    bound_ms, bound_by, _, t_bytes = bound(fwd_ops, fwd_bytes)
    bwd_bound_ms, bwd_bound_by, _, bwd_t_bytes = bound(bwd_ops, bwd_bytes)
    print(f"timing ({smi}): fwd kernel {ms:.3f} ms = {steps / ms * 1e3:.4e} substeps/s; plain "
          f"{plain_ms:.3f} ms = {steps / plain_ms * 1e3:.4e} substeps/s; bound {bound_ms:.3f} ms "
          f"({fwd_ops:.4e} FLOP at f32 peak; {fwd_bytes} B = {t_bytes:.4f} ms at HBM peak)")
    print(f"timing ({smi}): bwd kernel {bwd_ms:.3f} ms at B={COHORT}; plain "
          f"{bwd_plain_s * 1e3:.3f} ms once at B={BWD_B}; bound {bwd_bound_ms:.3f} ms "
          f"({bwd_ops:.4e} FLOP at f32 peak; {bwd_bytes} B = {bwd_t_bytes:.4f} ms at HBM peak)")
    print(f"timing ({smi}): share of bound fwd {100 * bound_ms / ms:.1f}% bwd "
          f"{100 * bwd_bound_ms / bwd_ms:.1f}%; before the redesign fwd "
          f"{PREVIOUS_MS['fused_rk4_fwd']} ms bwd {PREVIOUS_MS['fused_rk4_bwd']} ms (not measured "
          "in this run)")

    # the second-derivation kernel, its probes and what they decompose
    vjp_ms = {}
    with torch.no_grad():
        for impl in fused_rk4.VJP_IMPLS:
            vjp_ms[impl] = time_ms(lambda: fused_rk4.fused_rk4_bwd_vjp(
                traj_full, gbar_full, *packed[1:], SUBSTEPS, (), "mul", "f32", impl), 2, 20)
        bf16_ms = {
            "fwd": time_ms(lambda: fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS, (), "mul", "bf16"),
                           2, 20),
            "bwd": time_ms(lambda: fused_rk4.fused_rk4_bwd(
                traj_full, gbar_full, *packed[1:], SUBSTEPS, (), "mul", "bf16"), 2, 20)}
    # Both schedules compute the hand adjoint's function, so they share its
    # operation count; 'recompute' returns the parameter cotangents as one (32,)
    # row. Its second forward pass per interval is the schedule's choice, not
    # work the function needs: it is reported apart, not in the bound.
    vjp_bound = {"chained": bound(bwd_ops, bwd_bytes),
                 "recompute": bound(bwd_ops, bwd_bytes - 4 * (17 * COHORT - 32))}
    schedule_ops_ms = fwd_ops / PEAK_F32_FLOPS * 1e3
    print(f"timing ({smi}): second-derivation adjoint at B={COHORT}: "
          + "; ".join(f"'{i}' {vjp_ms[i]:.3f} ms (bound {vjp_bound[i][0]:.3f} ms by "
                      f"{vjp_bound[i][1]}, plain {vjp_plain_s[i] * 1e3:.3f} ms once at B={BWD_B})"
                      for i in ("recompute", "chained"))
          + f"; 'recompute' adds one forward pass per interval, {schedule_ops_ms:.3f} ms of "
          "operations at f32 peak, outside its bound; before the redesign 'recompute' "
          f"{PREVIOUS_MS['fused_rk4_bwd_vjp']} ms, 'chained' "
          f"{PREVIOUS_MS['fused_rk4_bwd_vjp_chained']} ms (not measured in this run)"
          + "; probes: " + ", ".join(f"{i} {vjp_ms[i]:.3f} ms" for i in PROBES))
    decomposition = {
        "one forward pass (probe_fwd1)": vjp_ms["probe_fwd1"],
        "a second forward pass (probe_fwd2 - probe_fwd1)": vjp_ms["probe_fwd2"] - vjp_ms["probe_fwd1"],
        "state cotangent chain (probe_y - probe_fwd1)": vjp_ms["probe_y"] - vjp_ms["probe_fwd1"],
        "weight cotangents (probe_yw - probe_y)": vjp_ms["probe_yw"] - vjp_ms["probe_y"],
        "parameter and context cotangents (chained - probe_yw)":
            vjp_ms["chained"] - vjp_ms["probe_yw"],
    }
    print(f"decomposition of the 'chained' adjoint ({smi}): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in decomposition.items())
          + f"; the state chain with its forward pass, probe_y {vjp_ms['probe_y']:.3f} ms, is "
          f"probe_y_mlp {vjp_ms['probe_y_mlp']:.3f} ms with the MLP alone and probe_y_mech "
          f"{vjp_ms['probe_y_mech']:.3f} ms with the mechanistic drift alone")
    print(f"timing ({smi}): mlp_dtype='bf16' at B={COHORT}: fwd kernel {bf16_ms['fwd']:.3f} ms "
          f"(f32 {ms:.3f} ms), hand adjoint kernel {bf16_ms['bwd']:.3f} ms (f32 {bwd_ms:.3f} ms)")

    # identify_context per step: the test split, and the cohort's windows with
    # the r2 checkpoint (one step = forward kernel + hand adjoint + Adam on the codes)
    def id_step_ms(b, steps):
        identify_context(params2, b, config2, steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        identify_context(params2, b, config2, steps=steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    cohort_batch = dict(batch, external_inputs={"meal": sig["meal"], "tVNS": sig["tVNS"]},
                        loss_weights=torch.as_tensor(ds.loss_weights, device=device))
    id_ms = {"test_split": id_step_ms(id_batch, ID_STEPS), "cohort": id_step_ms(cohort_batch, 10)}
    print(f"timing ({smi}): identify_context per step (host clock, {k_id} points, H=128, params "
          f"mode): {id_ms['test_split']:.3f} ms at B={len(test_ds)}, {id_ms['cohort']:.3f} ms at "
          f"B={COHORT}")

    lambda2 = cfg["training"]["lambda2"]
    train_batch = dict(batch, external_inputs={"meal": sig["meal"], "tVNS": sig["tVNS"]},
                       mask=torch.ones((COHORT, T), device=device),
                       loss_weights=torch.as_tensor(ds.loss_weights, device=device))
    step128 = train_step_fn(state["params"], train_batch, config, lambda2)
    step_ms = time_ms(step128, 2, 20)
    bench_cfg = config_from_dict({"model": {"solver": "rk4", "nn_hidden": 64, "substeps": 4,
                                            "use_pallas": True}})
    p64 = init_hybrid_params(torch.Generator().manual_seed(0), bench_cfg, device=device)
    p64["nn"]["w4"] = 0.01 * torch.randn(p64["nn"]["w4"].shape,
                                         generator=torch.Generator().manual_seed(2)).to(device)
    step64_ms = time_ms(train_step_fn(p64, bench_train_batch(device), bench_cfg, lambda2), 2, 20)
    b64 = kernel_ops(p64["nn"], 4, 64, COHORT, T, SUBSTEPS)
    train_bounds = {"H128_C16": bound_ms + bwd_bound_ms,
                    "H64": (b64[0] + b64[1]) / PEAK_F32_FLOPS * 1e3}
    print(f"timing ({smi}): train step (fwd kernel + bwd kernel + loss + Adam) at B={COHORT} "
          f"T={T}: H=128 C=16 {step_ms:.3f} ms (kernel bound {train_bounds['H128_C16']:.3f} ms); "
          f"H=64 no context {step64_ms:.3f} ms (kernel bound {train_bounds['H64']:.3f} ms)")

    wall_ms, kernels = profile_ms(step128)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"profile ({smi}): one train step at B={COHORT} H=128 C=16: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} "
          "kernel names; top: " + "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, (ms, n) in top))
    report["train_step_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": kernels}

    entries = [
        {"name": "fused_rk4_fwd", "route": "cuda",
         "source": "hybrid_ode_torch/csrc/fused_rk4_fwd.cu",
         "replaces": "hybrid_ode_tpu/ops/pallas_rk4.py:253",
         "launches": launches + train_launches[0] + id_launches[0] + bayes_launches[0],
         "max_abs_err": max(max_abs.values()),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None, "ms_bf16": bf16_ms["fwd"]},
        {"name": "fused_rk4_bwd", "route": "cuda",
         "source": "hybrid_ode_torch/csrc/fused_rk4_bwd.cu",
         "replaces": "hybrid_ode_tpu/ops/pallas_rk4.py:414",
         "launches": train_launches[1] + id_launches[1] + bayes_launches[1],
         "max_abs_err": max(bwd_max_abs.values()),
         "ms": bwd_ms, "plain_ms": bwd_plain_s * 1e3, "plain_batch": BWD_B,
         "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by, "library_ms": None,
         "ms_bf16": bf16_ms["bwd"]},
        {"name": "fused_rk4_bwd_vjp", "route": "cuda",
         "source": "hybrid_ode_torch/csrc/fused_rk4_bwd_vjp.cu",
         "replaces": "hybrid_ode_tpu/ops/pallas_rk4.py:692",
         "launches": id_launches[2], "max_abs_err": max(vjp_max_abs.values()),
         "ms": vjp_ms["recompute"], "plain_ms": vjp_plain_s["recompute"] * 1e3,
         "plain_batch": BWD_B, "bound_ms": vjp_bound["recompute"][0],
         "bound_by": vjp_bound["recompute"][1], "library_ms": None,
         "ms_chained": vjp_ms["chained"], "plain_ms_chained": vjp_plain_s["chained"] * 1e3,
         "bound_ms_chained": vjp_bound["chained"][0], "schedule_ops_ms": schedule_ops_ms},
    ]
    report.update(kernels=entries, flops={"fwd": fwd_ops, "bwd": bwd_ops},
                  bytes={"fwd": fwd_bytes, "bwd": bwd_bytes}, substeps=steps,
                  train_step_ms={"H128_C16": step_ms, "H64": step64_ms},
                  train_step_bound_ms=train_bounds, vjp_ms=vjp_ms, bf16_ms=bf16_ms,
                  decomposition_ms=decomposition, identify_step_ms=id_ms,
                  previous_ms=PREVIOUS_MS, tile=tile, routes=routes)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
