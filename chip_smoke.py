#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; each prints its wall time, and any failure is an
uncaught exception and a nonzero exit:

1. device: the card's name and power limit (nvidia-smi); TF32 off, bf16
   products with f32 accumulation.
2. build:  compile the seven CUDA sources from njode_tpu_torch/ops/csrc, one
   nvcc per source, started together; the gap kernel's registers by
   instance, failing on any spill.
3. kernel vs plain: the whole-gap kernel against its plain PyTorch version
   over activation x scaling x K_h x d_h (50, 256, and 300 in 256-column
   chunks) x rows, zero/partial gaps and max_substeps=0; one 100-substep
   row in a warp's group with short rows (d_h 256: R 4 and 67); one block
   a network whose rows take 3 passes of its sort: h to rtol 1e-4 / atol
   1e-5 (fma contraction and summation order over 100 substeps), t_L
   bitwise; two calls at the predict_at shape bitwise equal.
4. batch serving: 1,000 Black-Scholes streams x 21 queries through
   NeuralJumpODE.predict_at of the production model (hidden 50, shared, two
   moments, dt_ode_step 0.01), checked against the same model on the CPU
   (where the plain version runs); one separate-network request too.
5. streaming serving: NJODEFilter on 256 streams for 20 ticks, checked
   against predict_at on the same history.
6. times (CUDA events, median of 30 after warm-up): kernel vs plain and
   its bound at the predict_at, filter and d_h 256 shapes, predict_at
   queries/s, filter tick latency.
7. build: the training kernel's registers and spill bytes by template
   instance (built in 2).
8. training kernel vs plain: fused_train_run against its plain version over
   8 steps of N = 10 slots, batch 128 with a trajectory-masked last
   minibatch, K in (1, 2) x H in (32, 64, 128) x direct/second_moment x
   relu/identity, tanh/tanh, selu/identity, then H 50 (zero-padded to 52)
   and batch 1, 13 and 1,024, and 2 steps of H 128 at N 25 (the slots in
   device memory): per-step losses, params, Adam m and v to rtol 1e-4 /
   atol 1e-5 (f32 sums in other orders, and contracted multiply-adds,
   through 8 Adam steps); 2 steps of H 128 at batch 1,024 with the losses,
   m and v so and the params within 1e-3 of their norm (section 6 of
   PERF.md says why); two calls on the same input bitwise equal.
9. the default training path: run_experiment of the default Black-Scholes
   config (the values experiments/common.py build_config makes from the
   CLI defaults) for 5 epochs on the card, one kernel launch per epoch,
   then a second call to 7 epochs that resumes at epoch 5; then one epoch
   of identical packed data through the kernel and the composed path
   (apply_loss + autograd + torch.optim.Adam) from identical weights, at
   the tolerance of phase 8.
10. training times (host clock around synchronized work, CUDA events for
   kernels): the full default recipe (200 epochs x 1,000 fresh
   trajectories) through Trainer.train with the kernel; the same recipe as
   one fused_train_run over all epochs' packed data, as bench.py runs it;
   the composed path (Trainer.train with the same validation) and the plain
   version, each warmed by one epoch, then 20 epochs timed and scaled to
   200; val MSE of the trained model against the closed-form moments
   (bench.py:435-455).
11. build: the walk sources' ptxas summaries (built in 2); walk_scan.cu's
   registers by kernel instance, failing on any spill (rows 7 and 8).
12. walk kernels vs plain: walk_gaps_fused (forward, and its backward
   through autograd) against walk_gaps_reference, d_h in (12, 50, 125) x
   rows in (16, 256, 2000) x K_h in (1, 2) x three activation/scaling
   pairs, M = 100, ragged rows and slots at t = T: the forward at rtol 1e-4
   / atol 1e-5, every cotangent within 1e-3 of its norm (section 6 of
   PERF.md says why not entrywise); then the production shape (256 rows, H
   50) at K_h 1 and 2, and 384 rows at K_h 2 (2 warps a row), against
   walk_vjp_reference (the plain pair of the kernels' data flow: residuals,
   the backward's records, the weight sums in chunk order) at the same
   tolerances, and two calls bitwise equal; the forward alone at 512, 513,
   1,024 and 1,025 rows (K_h 1), where walk_fwd_plan's warps a row switch
   from 4 to 2 to 1, at the forward's tolerance, two calls bitwise equal.
13. walk-train kernel vs plain: fused_walk_train_run against its plain
   version, 8 steps at the production shape (H 50, N 10, batch 256,
   M 100), then K x euler/heun/rk4 x direct/second_moment at batch 64,
   then 2 steps at the widest shape the gate admits (H 128, batch 1,024,
   rk4: the step buffer in chunks of cells, O1 and J2 sharing a plane), the
   last minibatch trajectory-masked: losses and params at rtol 1e-4 / atol
   1e-5, Adam m and v within 1e-3 of their norm; two calls at the
   production shape bitwise equal.  Before it, walk_train.cu's registers
   and spill bytes by template instance.
14. the production training path: run_experiment of the production config
   (scripts/run_black_scholes.sh's flags through build_config, --kernels
   auto) for 3 epochs, then resumed to 5, one walk-train launch per epoch;
   one epoch of Trainer.train on the composed grid-walk path (the walk
   kernels under autograd); run_experiment of the production config without
   --shared-network (K_h 2) under --kernels auto, 2 epochs then resumed to
   3: the walk-train kernel needs a shared network, so rows 7 and 8 launch
   once a step, row 1 in validation, nothing else; then one epoch of
   identical packed data through the walk-train kernel and the composed path
   from identical weights.
15. production times: the full production recipe (200 epochs x 10,000
   fresh trajectories) through Trainer.train with the walk-train kernel
   (all epochs when they fit in 90 s, else 20 scaled); the composed
   grid-walk path and the per-gap composed path, each warmed by one epoch,
   2 timed and scaled; one epoch call of the kernel and of its plain
   version; rows 7-8 at their main-path shapes (256 rows, K_h 2 and 1)
   against their plain versions and bounds; the validation A/B that sets
   the walk's row cap; val MSE against the closed-form moments.
16. build: fused_step.cu's ptxas summary and registers and spill bytes by
   function (built in 2: the f32 forward and backward, their out-of-line
   product chunks by rows a thread, the dW sum and its chunk sum, the bf16
   kernels), and the tensor-core instructions (HMMA/HGMMA in the SASS,
   cuobjdump) of each kernel: not 0 for any of the three bf16 kernels, 0
   for the f32 ones (CUDA-core fma).
17. fused-step kernels vs plain: rows 9-10 (njode_step_fwd, njode_step_bwd,
   f32 on the CUDA cores: csrc/step_f32.cuh) against fused_step_forward_reference /
   fused_step_backward_reference (cuBLAS f32, TF32 off), H in (32, 50, 256)
   x N in (1, 2, 10) x separate/shared x L in (1, 2), relu/identity,
   tanh/tanh, elu/sigmoid and rows 4,096, 1,696, 5,000 in turn, then the
   scaled path's own shape (H 256, N 2, separate, L 1, relu/identity, 4,096
   rows): the forward at rtol 1e-4 / atol 1e-5 and within 1e-5 of its norm,
   every dW plane and dV row within 1e-4 of its norm (1e-3 with relu,
   whose kinks turn under another summation order); the control, the plain
   version in 1xTF32 on the same input (its products' operands rounded to
   TF32, allow_tf32 on: cuBLAS alone keeps f32 where the inner dimension is
   not a multiple of 4, as at H 50), must fail the forward and the backward
   check in every case (the worst share of each limit printed for the
   kernel, the smallest for the control); two backward calls bitwise
   equal.
18. the scaled training path: run_experiment of the scaled config
   (scripts/run_scaled_sweep.sh's flags through build_config: hidden 256,
   two networks, batch 4,096, 100,000 fresh trajectories per epoch,
   validation on 5,000, --kernels step) for 2 epochs, then resumed to 3:
   row 10 once a step, row 9 once a step and once per validation and
   relative-loss call, no other kernel; then one epoch of identical data
   through the fused-step kernels and the composed path from identical
   weights.
19. scaled times: the full 100-epoch recipe through Trainer.train on the
   fused-step kernels; the composed path (use_pallas False), warmed by one
   epoch, 5 timed and scaled to 100; the A/B behind the "auto" gate (one
   epoch each, in turns; "auto" must take the kernels at this shape); rows
   9 and 10 per call at 4,096 rows (row 9 also at 5,000) against their
   plain versions and bounds (f32-accurate products at 3xTF32 on the tensor
   cores, the CUDA cores' f32 bound and the bytes of the backward's records
   and partials beside);
   val MSE against the closed-form moments.

20. build: gap_train.cu's and fused_cell.cu's ptxas summaries (built in 2);
   gap_train.cu's and fused_cell.cu's registers by kernel instance, failing
   on any spill of the forward (rows 2-3), the backward (rows 4-5) or row
   6's instances with the weights in registers.
21. gap training kernels vs plain: rows 2-5 (njode_gap_train_fwd at
   residual stride 1 and 8, njode_gap_train_bwd) against
   gap_train_forward_reference / gap_train_backward_reference, n_sub in
   (1, 10, 16, 17, 100) x d_h in (12, 50, 128) x K_h in (1, 2), three
   activation/scaling pairs and rows 16, 2,304, 18,000, 1,001 in turn:
   h_L and the stored states at rtol 1e-4 / atol 1e-5, t_L and the stored
   t bitwise, every backward output and every cotangent through autograd
   (integrate_gap_fused against integrate_gap_reference) within 1e-3 of
   its norm, each backward output also within 1e-3 of its norm of the
   plain pair of the backward's data flow (gap_bwd_records_reference: the
   substep counts, whose t sequence must be the forward's t_L bitwise, the
   longest-first order, records by segment, chunked sums), two backward
   calls bitwise equal; then row 5's scheduling at n_sub 100: a long gap
   amid short ones, counts straddling the long threshold, 18,000 rows at
   d_h 128 and K_h 2 (the step buffer's largest case), and n_sub 1,100;
   on the long gap amid short ones, the pair at stride 1 and at stride 8
   bitwise equal (h_L, t_L, the checkpoints at the shared positions, every
   backward output) and the forward on permuted rows and on subsets of
   the rows that move rows to another walker bitwise equal row by row;
   then row 6 (njode_fused_cell) against fused_cell_reference at the
   forced default path's shapes, the production width, a ragged wide one
   and d_h 512 and 1,800 (fewer warps a block): out and pre at rtol 1e-4 /
   atol 1e-5, the Function's gradients within 1e-3 of their norm.
22. the forced training paths (use_pallas True, the CLI's --kernels
   force): run_experiment of the production config with grid_walk off, 2
   epochs then resumed to 3, rows 3 and 5 once a step and row 1 in
   validation, no other kernel; of the default config, 3 epochs, row 6
   once per apply and no other kernel; of the production config at
   dt_ode_step 0.1, one epoch, rows 2 and 4 once a step (not 3 and 5);
   then one epoch of identical data through the forced kernels and the
   composed path from identical weights, for both recipes, at phase 14's
   tolerances.
23. forced times: one epoch of each forced recipe against its composed
   twin, in turns after a warm-up epoch; rows 2-6 per call at their
   main-path shapes against their plain versions and bounds, with each
   kernel's device time (torch.profiler); at those shapes rows 2-5 held
   against their plain versions, the pair at stride 1 and at stride 8 on
   the forced production minibatch bitwise equal, and the forward on
   permuted rows and on subsets of the rows bitwise equal; the
   residual stride A/B (1, 4, 8, 16) at n_sub 100.
24. bf16 fused-step kernels vs plain: rows 9b-10b (the bf16 instances of
   njode_step_fwd / njode_step_bwd, compute_dtype bfloat16, bf16 mma with
   f32 accumulation) bitwise against their plain versions on a case whose
   every f32 operation is exact (one trajectory, H 16, one hidden layer)
   but which the bf16 rounding changes; then on phase 17's grid and the
   scaled path's shape: the forward at rtol 2e-2 / atol 2e-3, every dW
   plane and dV row within 5e-2 of its norm (one-ulp flips of downstream
   bf16 roundings under another f32 summation order), and the ratio test
   (Y, each dW plane and dV row no further from the plain bf16 run, in
   norm, than 0.1 x, the backward 0.2 x, the plain bf16 run from the plain
   f32 run), which the f32 instance on the same input (the control) must
   fail; two backward calls bitwise equal.
25. the bf16 scaled training path: run_experiment of the scaled config with
   compute_dtype bfloat16 (scripts/run_scaled_sweep.sh --compute-dtype
   bfloat16 through build_config) for 2 epochs, then resumed to 3: row 10b
   once a step, row 9b once a step and once per validation and
   relative-loss call, rows 9-10 and every other kernel 0; then one bf16
   epoch of identical data through rows 9b-10b and through their plain
   versions from identical weights (per-step losses at phase 24's forward
   tolerance, each parameter within 5e-2 of its norm).
26. bf16 times: the bf16 recipe (100 epochs) through Trainer.train on rows
   9b-10b with its launches by row; the bf16 kernels, the f32 kernels and
   the composed bf16 path (cuBLAS bf16 products, f32 accumulation), each
   warmed by one epoch, 10 epochs each in turns, scaled to 100 (the A/B
   behind "auto"'s compute dtypes), then 2 epochs of each profiled (device
   time, idle share, launches); rows 9b and 10b per call at 4,096 rows
   (9b also at 5,000) against their plain versions and bounds (bf16 peak);
   val MSE of the bf16 and f32 recipes at seeds 0 and 1 (reported, not
   gated).
27. bf16 whole-run kernels vs plain: rows 11b-12b and 13b (the bf16
   instances of train_run.cu and walk_train.cu, train_kernel_mxu
   "bfloat16") against their plain versions with the same rounding points,
   on a subset of phases 8 and 13's cases with both recipes' shapes and a
   trajectory-masked last minibatch: per-step losses at rtol 5e-4 / atol
   1e-5, params, Adam m and v each within 1e-4 of its norm, and the ratio
   test (the kernel's largest distance from the plain bf16 run, in the
   losses and in the params, at most 0.1 x the plain bf16 run's from the
   plain f32 run), which pins where the kernel rounds; the f32 instance on
   the same input must fail these checks (the control); the worst case's
   share of each limit printed, and the plain version's own spread against
   its float64 run; two calls bitwise equal at each recipe's shape; ptxas
   registers and spills of the bf16 instances.
28. the bf16 training paths: run_experiment of the default and the
   production configs with train_kernel_mxu "bfloat16", 3 epochs then
   resumed to 4, each in its own window: row 11b / 13b once an epoch, rows
   11-13 in f32 and rows 2-10 not at all, row 1 only in the production
   validation; the saved config keeps the mode.
29. bf16 whole-run times: rows 11b and 13b per epoch call against rows 11
   and 13 in turns, their plain versions and bounds (bf16 peak); both bf16
   recipes through Trainer.train in turns with the f32 recipes at seeds 0
   and 1, each run's launches checked; val MSE of each (reported, not
   gated).
30. the other families' default recipes: run_experiment of the default
   config with the OU, Heston and hybrid process (bench.py:169-176's
   parameters; obs-only for OU and hybrid, Heston on the grid), 20 epochs
   each in its own window: rows 11-12 once an epoch, no other kernel; then
   one epoch of identical data of each family through rows 11-12 and the
   composed path from identical weights (phase 9's check); seconds,
   trajectories/s, idle share (2 profiled epochs of Trainer.train) and val
   MSE against the family's closed forms.
31. their production recipes (scripts/run_{ou,heston,hybrid}.sh's flags):
   3 epochs each in its own window, row 13 once an epoch, row 1 in
   validation and the relative loss, nothing else; Heston's 100-step
   variance recurrence on the card; the same figures; then Heston's data
   generation an epoch beside the epochs it feeds.
32. rows 9-10 at d_x = d_y = 2 (the scaled d=2 shape, H 256, N 2, two
   networks, L 1; relu/identity at 4,096 rows, tanh/tanh at 1,696) against
   their plain versions at phase 17's limits, the 1xTF32 control failing
   them, two backward calls bitwise equal; their CUDA-event times at d_x 2
   beside d_x 1 in turns, with the bound at d_x 2.
33. the scaled d=2 recipe (bench.py --process black_scholes_nd --dims 2
   --scaled), then ornstein_uhlenbeck_nd: run_experiment, one epoch each in
   its own window, row 10 once a step, row 9 once a step, once for the
   validation and once for the relative loss, nothing else; the same
   figures.
34. serving at d_x 2: predict_at of a production-d=2 model (hidden 50,
   shared, dt_ode_step 0.01) for 1,000 black_scholes_nd streams x 21
   queries in its own window (row 1 only), row 1 against its plain version
   on its own arguments (t_L bitwise, h at rtol 1e-4 / atol 1e-5),
   predict_at against the CPU model, and row 1's times at d_x 2 beside
   d_x 1 in turns.
35. grid rollout: NeuralJumpODE.predict_on_grid of the production model on
   1,000 Black-Scholes grid paths x 101 points (obs fraction 0.1; some
   paths first observed late, some not after t = 0.8) in its own window:
   no kernel (a loop of composed _euler substeps), held against the CPU
   model at rtol 1e-4 / atol 1e-5, zeros before each path's first
   observation; the same call under use_pallas=True: row 6 G x n_sub times
   and nothing else, agreeing with the unforced call at those limits; a
   separate-network (K_h 2) call against the CPU; CUDA-event times of both
   in turns, grid points/s, one profiled call's idle share.
36. generative sampling: sample_paths of the production model, 1,000 paths
   x 101 grid points, each law (gaussian, lognormal, mean), from x0 1.0 and
   from a 10-observation prefix, each call in its own window: row 1 G - 1
   times (G with the prefix) and nothing else; sample_paths_from_normals on
   a CPU twin with the card's normals (the first 250 paths): the whole mean
   path and the first stochastic step at rtol 1e-4 / atol 1e-5, whole
   stochastic paths within SAMPLE_PATH_NORM of their norm (sampling_phase
   says why); two calls of one seed bitwise equal; ms a call, samples/s.
37. the experiment CLIs in process (njode_tpu_torch.experiments, main(argv),
   --device cuda --no-plots, runs/ in a temporary directory), a window a
   run: the default recipe 3 epochs (rows 11-12 once an epoch, nothing
   else; config.json equal to build_config's dict), resumed to 4 (one
   launch); scripts/run_black_scholes.sh's flags 2 epochs (row 13 once an
   epoch, row 1 in validation); OU, Heston and hybrid at their defaults 2
   epochs each (rows 11-12 once an epoch); one run with --profile-dir (a
   non-empty Chrome trace with kernels); one run asking for plots: the
   three PNGs where matplotlib imports, else its ImportError after
   training (the line says which).

The recipes' configs (default_config, production_config, scaled_config,
family_config and their variants) are the port's build_config of each
recipe's CLI flags (RECIPE_FLAGS; tests/test_torch_cli.py holds them equal
to the dicts this script used to write out).

Each kernel's launch count is reset just before its main path (phases 4-5
for the gap kernel, 9 for the training kernel, 14 for the walk kernels (the
separate-network path) and the walk-train kernel, 18 for the fused-step
kernels, 22 for rows 2-6, one window per forced path, 25 for rows 9b-10b, 28
for rows 11b and 13b, 30, 31, 33 and 34 a window per run, 35-37 a window a
call or run, every row's count read in each) and read just after.  The last
line is the JSON result; the line before it lists the kernels, each with
its main path's launches and, under "also", the launches of the other
windows that ran it in phases 35-37.  There is no CPU run: without a CUDA
device the script fails.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

from njode_tpu_torch import NeuralJumpODE, NJODEFilter, sample_paths
from njode_tpu_torch.experiments import experiment_black_scholes as ebs
from njode_tpu_torch.experiments import experiment_heston as ehe
from njode_tpu_torch.experiments import experiment_hybrid as ehy
from njode_tpu_torch.experiments import experiment_ou as eou
from njode_tpu_torch.generative import STEP_LAWS, sample_paths_from_normals
from njode_tpu_torch.models import nj_ode_loss_dense, pad_ragged
from njode_tpu_torch.ops import fused_step as fs
from njode_tpu_torch.ops import fused_cell, gap_scan, walk_scan
from njode_tpu_torch.ops import train_kernel as tk
from njode_tpu_torch.ops import walk_train as wt
from njode_tpu_torch.simulation import (bs_paths, moments_at_obs,
                                        sample_obs_indices, simulate_batch,
                                        supports_obs_only)
from njode_tpu_torch.utils import (Trainer, conditional_moment_mse,
                                   create_data_loaders, load_checkpoint,
                                   make_adam, run_experiment)
from njode_tpu_torch.utils.training import as_dense

RTOL, ATOL = 1e-4, 1e-5
DT, N_SUB = 0.01, 100
GAP_WIDE_DH = 300      # row 1's wide case: past 256 columns, in chunks
KERNEL_SOURCE = "njode_tpu_torch/ops/csrc/gap_scan.cu"
REPLACES = "njode_tpu/ops/gap_scan.py:201"
TRAIN_SOURCE = "njode_tpu_torch/ops/csrc/train_run.cu"
TRAIN_REPLACES = ("njode_tpu/ops/train_kernel.py:223 (_train_kernel), "
                  "njode_tpu/ops/train_kernel.py:478 (_train_kernel_dual)")
WALK_SOURCE = "njode_tpu_torch/ops/csrc/walk_scan.cu"
WALK_TRAIN_SOURCE = "njode_tpu_torch/ops/csrc/walk_train.cu"
STEP_SOURCE = "njode_tpu_torch/ops/csrc/fused_step.cu"
SOURCES = ["gap_scan", "train_run", "walk_scan", "walk_train", "fused_step",
           "gap_train", "fused_cell"]
# the H100 SXM's published peaks: f32 outside the tensor cores, bf16 and
# TF32 dense on the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_TF32_FLOPS = 495e12
BF16 = torch.bfloat16


def device_phase() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (the composed bf16 path) accumulate in f32, as the JAX
    # package's preferred_element_type=f32 does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("matmul: TF32 off, bf16 reduced-precision reduction off",
          flush=True)
    return torch.device("cuda:0"), card


def build_phase() -> float:
    """All seven kernel sources, one nvcc each, started together; prints
    the gap kernel's line and returns the build time."""
    from njode_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(SOURCES)
    gap_scan._load_kernel()
    tk._load_kernel()
    walk_scan._load_kernel()
    wt._load_kernel()
    fs._load_kernel()
    gap_scan._load_train_kernel()
    fused_cell._load_kernel()
    took = time.perf_counter() - t0
    print(f"build: gap_scan.cu in {took:.2f} s (with {', '.join(SOURCES[1:])}"
          f", in parallel); ptxas by instance <columns a lane, weights "
          f"staged, wide>: {ptxas_check('gap_scan')}",
          flush=True)
    return took


def ptxas_summary(name: str) -> str:
    """Registers and spills over a source's kernels (one line for the many
    template instances)."""
    import re
    from njode_tpu_torch.ops import _build
    log = _build.BUILD_LOG.get(name, "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        return "no ptxas output (built before this process)"
    return (f"{len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill bytes max {max(spills, default=0)}")


def ptxas_instances(name: str) -> str:
    """Registers and spill bytes of each template instance of a source's
    kernels, as ptxas reported them in this process's build."""
    import re
    from njode_tpu_torch.ops import _build
    out, entry, spill = [], None, 0
    for ln in _build.BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            args = re.findall(r"L[ib](\d+)E", entry)
            typ = "bf16 " if "nv_bfloat16" in entry else ""
            out.append(f"{typ}<{', '.join(args)}> {m.group(1)} registers, "
                       f"{spill} spill bytes")
            entry, spill = None, 0
    return "; ".join(out) if out else "no ptxas output"


def kernel_label(entry: str) -> str:
    """kernel<template arguments> of a mangled ``*_kernel`` entry name (the
    name is the identifier ending in "_kernel" whose length prefix fits)."""
    import re
    for m in re.finditer(r"_kernel(?=[IE])", entry):
        end = m.end()
        for start in range(m.start() - 1, 0, -1):
            name = entry[start:end]
            if entry[:start].endswith(str(len(name))) and (
                    name[0].isalpha() or name[0] == "_"):
                t = re.match(r"I((?:L[ib]\d+E)+)E", entry[end:])
                args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
                return name + (f"<{', '.join(args)}>" if args else "")
    return entry


def ptxas_kernels(name: str) -> list[tuple[str, int, int]]:
    """(kernel<template arguments>, registers, spill bytes) of each kernel
    instance of a source, as ptxas reported them in this process's build."""
    import re
    from njode_tpu_torch.ops import _build
    out, entry, spill = [], None, 0
    for ln in _build.BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append((kernel_label(entry), int(m.group(1)), spill))
            entry = None
    return out


def ptxas_check(name: str, gated: tuple = ()) -> str:
    """ptxas_kernels as one line; fails if a kernel named in ``gated``
    (all when empty) spills."""
    kernels = ptxas_kernels(name)
    if not kernels:
        return "no ptxas output (built before this process)"
    spills = [k for k in kernels if k[2] and (
        not gated or k[0].split("<")[0] in gated)]
    if spills:
        raise AssertionError(f"{name}.cu: kernels spill: {spills}")
    return "; ".join(f"{k} {r} registers, {sp} spill bytes"
                     for k, r, sp in kernels)


def cell_ptxas_check() -> str:
    """fused_cell.cu's kernels as ptxas_check prints them; fails if an
    instance with the weights in registers (the forced default path's)
    spills."""
    kernels = ptxas_kernels("fused_cell")
    if not kernels:
        return "no ptxas output (built before this process)"
    bad = [k for k in kernels if k[2] and k[0].startswith("fused_cell_kernel<1, 1")]
    if bad:
        raise AssertionError(f"fused_cell.cu: the register instances spill: "
                             f"{bad}")
    return "; ".join(f"{k} {r} registers, {sp} spill bytes"
                     for k, r, sp in kernels)


# fused_step.cu's functions by kind: the f32 instances (step_f32.cuh: the
# forward and backward, the out-of-line product chunks, the dW sum and its
# reduce) and the bf16 kernels with their out-of-line product and gradient
# sum of the same (NTW, RPW)
STEP_FUNCTIONS = (
    (r"f3211step_kernelILb0E", "f32 forward"),
    (r"f3211step_kernelILb1E", "f32 backward"),
    (r"f328mm_chunkILi(\d+)E", "f32 product chunk TM {}"),
    (r"f3214step_dw_kernel", "f32 dW sum"),
    (r"f3218step_reduce_kernel", "f32 chunk sum"),
    (r"step_fwd_kernelILi(\d+)ELi(\d+)E", "bf16 forward <NTW {}, RPW {}>"),
    (r"step_bwd_kernelILi(\d+)ELi(\d+)E", "bf16 backward <NTW {}, RPW {}>"),
)


def step_function_kind(name: str):
    """The STEP_FUNCTIONS label of a mangled fused_step.cu function, None
    for the rest (the bf16 mm_store / outer_sum count with their kernels)."""
    import re
    for pat, label in STEP_FUNCTIONS:
        m = re.search(pat, name)
        if m:
            return label.format(*m.groups())
    return None


def step_instances() -> dict:
    """Registers (kernels) and spill bytes of fused_step.cu's functions by
    STEP_FUNCTIONS label, as ptxas reported them in this process's build."""
    import re
    from njode_tpu_torch.ops import _build
    out, fn, entry = {}, None, None
    for ln in _build.BUILD_LOG.get("fused_step", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = step_function_kind(m.group(1))
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = step_function_kind(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            out.setdefault(fn, [None, 0])[1] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.setdefault(entry, [None, 0])[0] = int(m.group(1))
    return out


def step_tensor_core_counts() -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of fused_step.cu's
    library (cuobjdump --dump-sass) by STEP_FUNCTIONS label; a bf16
    kernel's count includes its out-of-line mm_store and outer_sum of the
    same (NTW, RPW)."""
    import re
    from njode_tpu_torch.ops import _build
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(_build._lib_path("fused_step"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    per_fn, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            per_fn[fn] = 0
        elif fn and re.search(r"\bHG?MMA\.", ln):
            per_fn[fn] += 1
    out = {}
    for name, n in per_fn.items():
        label = step_function_kind(name)
        helper = re.search(r"(mm_store|outer_sum)ILi(\d+)ELi(\d+)E", name)
        if label is not None:
            out[label] = out.get(label, 0) + n
        elif helper:
            for kind in ("forward", "backward"):
                key = f"bf16 {kind} <NTW {helper.group(2)}, RPW {helper.group(3)}>"
                if key in out or any(step_function_kind(f) == key for f in per_fn):
                    out[key] = out.get(key, 0) + n
    return dict(sorted(out.items()))


def gap_case(gen: torch.Generator, K: int, R: int, d_h: int, d_x: int,
             n_sub: int, dev: torch.device) -> dict:
    """Random gap inputs: zero gaps, gaps shorter than dt, gaps ending on a
    grid point, and gaps up to the full budget; torch-default weight law."""
    def uni(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound
    d_in = d_h + d_x + 2
    t0 = torch.floor(torch.rand(R, generator=gen) * 50) * DT   # on the grid
    kind = torch.randint(0, 4, (R,), generator=gen)
    steps = torch.randint(0, n_sub + 1, (R,), generator=gen).float()
    free = torch.rand(R, generator=gen) * (n_sub + 1) * DT
    short = torch.rand(R, generator=gen) * DT
    gap = torch.where(kind == 0, 0.0, torch.where(
        kind == 1, short, torch.where(kind == 2, steps * DT, free)))
    case = {
        "h": torch.randn(K, R, d_h, generator=gen) * 0.5,
        "x_scaled": torch.randn(R, d_x, generator=gen),
        "t_last": t0, "t_target": t0 + gap,
        "weights": gap_scan.split_weights((uni((K, d_h, d_in), d_in ** -0.5),
                                           uni((K, d_h), d_in ** -0.5),
                                           uni((K, d_h, d_h), d_h ** -0.5),
                                           uni((K, d_h), d_h ** -0.5))),
    }
    return {k: (gap_scan.GapWeights(*(w.to(dev) for w in v)) if k == "weights"
                else v.to(dev)) for k, v in case.items()}


def substep_args(c: dict, n_sub: int, act: str, scale: str) -> tuple:
    """The kernel's own arguments for a case (what the wrapper hands it)."""
    return gap_scan.substep_inputs(c["h"], c["x_scaled"], c["t_last"],
                                   c["t_target"], c["weights"], DT) + (
        DT, n_sub, act, scale)


def gap_pair_close(args: tuple, where: str) -> float:
    """Row 1 against its plain version on the kernel's own arguments: t_L
    bitwise, h_L at RTOL / ATOL; returns the largest abs err of h."""
    h_k, t_k = gap_scan.gap_substeps(*args)
    h_p, t_p = gap_scan.gap_substeps_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(t_k, t_p):
        raise AssertionError(f"t_L not bitwise equal at {where}: "
                             f"{int((t_k != t_p).sum())} rows differ")
    return assert_close(h_k, h_p, f"h_L at {where}")


def long_among_short_case(gen: torch.Generator, K: int, R: int,
                          dev: torch.device) -> dict:
    """gap_case's inputs at d_h 256 with every row short (0 to 3 substeps)
    but one, which takes all N_SUB substeps.  At d_h 256 the weights are
    read through L1 and a warp runs one group of 4 rows with no long tier,
    so the long row shares its warp's group with short rows: at R 4 the
    one block's one group, at R 67 a block of 17 owning 3 or 4 rows."""
    c = gap_case(gen, K, R, 256, 1, N_SUB, dev)
    gap = torch.randint(0, 4, (R,), generator=gen).float() * DT
    gap[R // 2] = (N_SUB + 0.5) * DT
    c["t_target"] = c["t_last"] + gap.to(dev)
    return c


def kernel_phase(dev: torch.device) -> float:
    gen = torch.Generator().manual_seed(3)
    worst_abs = worst_rel = 0.0
    n_cases = 0
    cases = [(d_h, R, K, act, scale, N_SUB)
             for d_h in (50, 256) for R in (1, 37, 21000) for K in (1, 2)
             for act in gap_scan.SUPPORTED_ACTS for scale in gap_scan.SCALINGS]
    # past 256 columns: the wide instance's 256-column chunks (w1t, b2 and
    # the base reread through L1)
    cases += [(GAP_WIDE_DH, R, K, act, scale, N_SUB)
              for R in (37, 4000) for K in (1, 2)
              for act in gap_scan.SUPPORTED_ACTS for scale in gap_scan.SCALINGS]
    cases += [(50, 37, K, act, "tanh", 0) for K in (1, 2)
              for act in ("relu", "selu")]
    with torch.no_grad():
        for d_h, R, K, act, scale, n_sub in cases:
            c = gap_case(gen, K, R, d_h, 1, max(n_sub, 1), dev)
            args = substep_args(c, n_sub, act, scale)
            h_k, t_k = gap_scan.gap_substeps(*args)
            h_p, t_p = gap_scan.gap_substeps_reference(*args)
            full = (c["h"], c["x_scaled"], c["t_last"], c["t_target"],
                    c["weights"], DT, n_sub, act, scale)
            f_k, ft_k = gap_scan.integrate_gap_fused(*full)
            f_p, ft_p = gap_scan.integrate_gap_reference(*full)
            torch.cuda.synchronize()
            where = f"d_h={d_h} R={R} K={K} act={act} scale={scale} n_sub={n_sub}"
            for a, b in ((t_k, t_p), (ft_k, ft_p)):
                if not torch.equal(a, b):
                    raise AssertionError(f"t_L not bitwise equal at {where}: "
                                         f"{int((a != b).sum())} rows differ")
            for a, b, what in ((h_k, h_p, "h_L"), (f_k, f_p, "h(t_target)")):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"non-finite {what} at {where}")
                err = (a - b).abs()
                bad = err > ATOL + RTOL * b.abs()
                if bad.any():
                    raise AssertionError(
                        f"{what} differs at {where}: max abs err "
                        f"{float(err.max()):.3e}, {int(bad.sum())} entries "
                        "beyond tolerance")
                worst_abs = max(worst_abs, float(err.max()))
                worst_rel = max(worst_rel, float(
                    (err / (b.abs() + ATOL)).max()))
            n_cases += 1
        # one row of N_SUB substeps in one warp's group with short rows
        # (the warp leaves the loop only when none of its rows moves)
        for K, R, act, scale in ((1, 4, "relu", "identity"),
                                 (2, 4, "tanh", "tanh"),
                                 (2, 67, "selu", "sigmoid")):
            c = long_among_short_case(gen, K, R, dev)
            worst_abs = max(worst_abs, gap_pair_close(
                substep_args(c, N_SUB, act, scale),
                f"one {N_SUB}-substep row in a warp's group with short ones, "
                f"d_h 256, R={R} K={K} {act}/{scale}"))
        # more rows a block than one pass of its sort holds: K past the
        # card's wave (at most 8 blocks an SM) leaves one block a network,
        # which owns all R rows and sorts them in ceil(R / GAP_MAX_PASS)
        # passes
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        K_mp, R_mp = 4 * n_sm + 2, 2 * gap_scan.GAP_MAX_PASS + 104
        for act, scale in (("relu", "identity"), ("tanh", "tanh")):
            c = gap_case(gen, K_mp, R_mp, 50, 1, N_SUB, dev)
            worst_abs = max(worst_abs, gap_pair_close(
                substep_args(c, N_SUB, act, scale),
                f"one block a network, K={K_mp} R={R_mp} (3 passes) "
                f"{act}/{scale}"))
            del c
        # two calls at the predict_at shape bitwise equal (the rows' groups
        # form as the block's atomics fall; a row's arithmetic does not
        # depend on them)
        model = production_model(dev)
        args = gap_rows(model, *batch_request(dev))
        one, two = gap_scan.gap_substeps(*args), gap_scan.gap_substeps(*args)
        torch.cuda.synchronize()
        if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
            raise AssertionError("row 1: two calls at the predict_at shape "
                                 "differ")
    plan = gap_scan.gap_plan(50, "identity")
    print(f"kernel vs plain: {n_cases} cases (act x scaling x K_h in (1, 2) x "
          f"d_h in (50, 256) x R in (1, 37, 21000), d_h {GAP_WIDE_DH} x R in "
          f"(37, 4000), + max_substeps=0), one {N_SUB}-substep row in a "
          f"warp's group with short ones (d_h 256, R 4 and 67), one block a "
          f"network over 3 passes of its sort (K {K_mp}, R {R_mp}): max abs "
          f"err {worst_abs:.3e}, max err/(|ref|+atol) {worst_rel:.3e}; t_L "
          f"bitwise equal; two calls at the predict_at shape bitwise equal; "
          f"plan at d_h 50 {tuple(plan)}", flush=True)
    return worst_abs


def assert_close(a: torch.Tensor, b: torch.Tensor, what: str,
                 rtol: float = RTOL, atol: float = ATOL) -> float:
    a, b = a.cpu(), b.cpu()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (a - b).abs()
    if (err > atol + rtol * b.abs()).any():
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e} "
                             f"beyond rtol={rtol} atol={atol}")
    return float(err.max())


def production_model(dev: torch.device, shared: bool = True,
                     use_pallas="auto") -> NeuralJumpODE:
    return NeuralJumpODE(
        input_dim=1, hidden_dim=50, output_dim=1, num_moments=2,
        n_hidden_layers=1, activation="relu", input_scaling="identity",
        shared_network=shared, dt_ode_step=DT, t_max=1.0, device=dev,
        use_pallas=use_pallas,
        generator=torch.Generator().manual_seed(0 if shared else 1))


def batch_request(dev: torch.device, n_streams: int = 1000, n_queries: int = 21):
    """BS streams (mu 0.1, sigma 0.5, x0 1, T 1, 100 steps, 10 observations);
    every 4th stream loses its first 3 observations, so its history is
    end-padded and it has queries before its first observation."""
    gen = torch.Generator().manual_seed(1)
    b = simulate_batch(n_streams, "black_scholes", 0.1, generator=gen,
                       mu=0.1, sigma=0.5, x0=1.0, T=1.0, n_steps=100)
    times = [t[3:] if i % 4 == 0 else t for i, t in enumerate(b.times)]
    values = [v[3:] if i % 4 == 0 else v for i, v in enumerate(b.values)]
    obs_t, obs_v, mask = pad_ragged(times, values, device=dev)
    query = torch.sort(torch.rand(n_streams, n_queries, generator=gen),
                       dim=1).values.to(dev)
    return obs_t, obs_v, query, mask


def batch_phase(dev: torch.device, model: NeuralJumpODE, request) -> None:
    obs_t, obs_v, query, mask = request
    out = model.predict_at(obs_t, obs_v, query, mask)
    torch.cuda.synchronize()
    launched = gap_scan.LAUNCHES
    if launched == 0:
        raise AssertionError("predict_at did not launch the gap kernel")
    raw = out["raw"]
    if raw.shape != (1000, 21, 1, 2) or not torch.isfinite(raw).all():
        raise AssertionError(f"predict_at raw: shape {tuple(raw.shape)}, "
                             "or non-finite values")
    first = torch.where(mask, obs_t, torch.inf)[:, :1]
    before = query < first
    if not before.any() or (raw[before] != 0).any():
        raise AssertionError("queries before the first observation must "
                             "exist and read exactly 0")
    cpu_model = copy.deepcopy(model).to("cpu")
    ref = cpu_model.predict_at(obs_t.cpu(), obs_v.cpu(), query.cpu(),
                               mask.cpu())
    err = assert_close(raw, ref["raw"], "predict_at vs plain (CPU)")
    assert_close(out["var"], ref["var"], "predict_at var vs plain (CPU)")

    sep = production_model(dev, shared=False)
    req = (obs_t[:64], obs_v[:64], query[:64], mask[:64])
    out_sep = sep.predict_at(*req)
    ref_sep = copy.deepcopy(sep).to("cpu").predict_at(
        *(x.cpu() for x in req))
    err_sep = assert_close(out_sep["raw"], ref_sep["raw"],
                           "separate-network predict_at vs plain (CPU)")
    print(f"batch serving: 21,000 queries (1,000 streams x 21), "
          f"{int(before.sum())} before the first observation read 0; "
          f"max abs err vs plain {err:.3e}; separate-network K=2 request "
          f"(64 x 21) max abs err {err_sep:.3e}; launches "
          f"{gap_scan.LAUNCHES} (predict_at {launched})", flush=True)


def stream_ticks(n_streams: int = 256, n_ticks: int = 20):
    gen = torch.Generator().manual_seed(2)
    ts = [0.02 * (i + 1) for i in range(n_ticks)]
    xs = 1.0 + 0.1 * torch.randn(n_ticks, n_streams, 1, generator=gen)
    return ts, xs


def streaming_phase(dev: torch.device, model: NeuralJumpODE) -> None:
    filt = NJODEFilter(model)
    ts, xs = stream_ticks()
    xs = xs.to(dev)
    state = filt.init_state(xs.shape[1])
    before = gap_scan.LAUNCHES
    for t, x in zip(ts, xs):
        state = filt.update(state, t, x)
        out = filt.predict(state, t + 0.02)
    torch.cuda.synchronize()
    if gap_scan.LAUNCHES <= before:
        raise AssertionError("NJODEFilter.predict did not launch the kernel")
    n = xs.shape[1]
    obs_t = torch.tensor(ts, dtype=torch.float32, device=dev).expand(n, -1)
    obs_v = xs.permute(1, 0, 2)
    query = torch.full((n, 1), ts[-1] + 0.02, dtype=torch.float32, device=dev)
    pa = model.predict_at(obs_t, obs_v, query)
    err = assert_close(out["raw"], pa["raw"][:, 0], "filter vs predict_at",
                       rtol=1e-5, atol=1e-5)
    print(f"streaming serving: {n} streams x {len(ts)} ticks (update at "
          f"t=0.02 i, predict at t+0.02); last predictions vs predict_at on "
          f"the same history max abs err {err:.3e}; launches "
          f"{gap_scan.LAUNCHES - before}", flush=True)


def time_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time_ms(fn, n: int = 10) -> float:
    """Device time of one call of fn, every kernel and copy it launches
    (torch.profiler over n calls after one of warm-up)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / (1e3 * n)


def gap_rows(model: NeuralJumpODE, obs_t, obs_v, query, mask=None) -> tuple:
    """The kernel's arguments as predict_at builds them for a request."""
    with model._inference():
        x, t_last, t_q, _ = model._query_rows(obs_t, obs_v, query, mask)
        c = {"h": model._jump(x), "x_scaled": model._scale(x),
             "t_last": t_last, "t_target": t_q,
             "weights": model._gap_weights()}
    return substep_args(c, model.max_substeps, model._act_key,
                        model._scale_key)


def timing_phase(dev: torch.device, card: str, model: NeuralJumpODE,
                 request) -> tuple[float, float]:
    obs_t, obs_v, query, mask = request
    args = gap_rows(model, obs_t, obs_v, query, mask)
    with torch.no_grad():  # in turns: plain, kernel, kernel, plain
        p_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*args))
        k_ms = time_ms(lambda: gap_scan.gap_substeps(*args))
        k2_ms = time_ms(lambda: gap_scan.gap_substeps(*args))
        p2_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*args))
    ts, xs = stream_ticks()
    xs = xs.to(dev)
    filt = NJODEFilter(model)
    state = filt.update(filt.init_state(xs.shape[1]), ts[-1], xs[-1])
    f_args = gap_rows(model, state.t_last[:, None], xs[-1][:, None],
                      state.t_last[:, None] + 0.02)
    with torch.no_grad():
        fk_ms = time_ms(lambda: gap_scan.gap_substeps(*f_args))
        fp_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*f_args))
    # the width of bench.py --scaled, gaps of every kind up to the budget
    wide = substep_args(gap_case(torch.Generator().manual_seed(4), 1,
                                 query.numel(), 256, 1, N_SUB, dev),
                        N_SUB, "relu", "identity")
    with torch.no_grad():
        wk_ms = time_ms(lambda: gap_scan.gap_substeps(*wide))
        wp_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*wide))
    pa_ms = time_ms(lambda: model.predict_at(obs_t, obs_v, query, mask))

    def tick():
        s = filt.update(state, ts[-1], xs[-1])
        filt.predict(s, ts[-1] + 0.02)
    tick_ms = time_ms(tick)
    n_q = query.numel()
    (b_pa, _), (b_f, _), (b_w, _) = (gap_bound(a) for a in (args, f_args,
                                                              wide))
    print(f"times on {card}: gap kernel {k_ms:.4f} / {k2_ms:.4f} ms vs plain "
          f"{p_ms:.4f} / {p2_ms:.4f} ms, bound {b_pa:.4f} ms, at the "
          f"predict_at shape (R={n_q}, d_h=50, max_substeps="
          f"{model.max_substeps}); at the filter shape (R={xs.shape[1]}, gap "
          f"0.02) kernel {fk_ms:.4f} ms vs plain {fp_ms:.4f} ms, bound "
          f"{b_f:.4f} ms; at d_h=256 (R={n_q}, random gaps) kernel "
          f"{wk_ms:.4f} ms vs plain {wp_ms:.4f} ms, bound {b_w:.4f} ms; "
          f"predict_at {pa_ms:.4f} ms = "
          f"{n_q / (pa_ms / 1e3):.0f} queries/s; filter tick (update + "
          f"predict, {xs.shape[1]} streams) {tick_ms:.4f} ms", flush=True)
    return statistics.median([k_ms, k2_ms]), statistics.median([p_ms, p2_ms])


def gap_bound(args: tuple) -> tuple[float, str]:
    """Least time of one gap_substeps call on the H100: the larger of its
    f32 work over 67 TFLOP/s (per row and full substep taken, two d_h x d_h
    products and the elementwise update: 4 d_h^2 + 4 d_h, the substeps
    counted from this request's t_L) and its bytes (each input read once,
    each output written once) over 3.35 TB/s."""
    h, base, t_last, t_target, w1h, w1t, w2, b2, dt = args[:9]
    K, R, d_h = h.shape
    with torch.no_grad():
        _, t_l = gap_scan.gap_substeps_reference(*args)
    steps = float(torch.round((t_l - t_last) / dt).sum())
    flops = K * steps * (4 * d_h * d_h + 4 * d_h)
    n_bytes = 4 * (2 * h.numel() + base.numel() + 2 * t_last.numel()
                   + t_target.numel() + w1h.numel() + w1t.numel()
                   + w2.numel() + b2.numel())
    return bound_of(flops, n_bytes)


def bound_of(flops: float, n_bytes: float,
             peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- training

TRAIN_N, TRAIN_BS, TRAIN_G = 10, 128, 8
# each family's parameters in its recipes (bench.py:169-176, the defaults of
# experiments/experiment_{black_scholes,ou,heston,hybrid}.py)
FAMILY_PARAMS = {
    "black_scholes": dict(mu=0.1, sigma=0.5, x0=1.0),
    "ornstein_uhlenbeck": dict(theta=1.0, mu=0.5, sigma=0.3, x0=0.0),
    "heston": dict(mu=0.5, kappa=2.0, theta=0.04, xi=0.5, rho=-0.5, x0=1.0,
                   v0=0.04),
    "hybrid_ou_bs": dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
                         sigma_bs=0.2, switch_time=None, x0=1.0),
    "black_scholes_nd": dict(mu=0.1, sigma=0.5, dims=2),
    "ornstein_uhlenbeck_nd": dict(theta=1.0, mu=0.5, sigma=0.3, dims=2),
}
TRAIN_EPOCHS = 200           # the default recipe's
COMPARED_EPOCHS = 20         # timed epochs of the composed and plain arms
ACT_PAIRS = (("relu", "identity"), ("tanh", "tanh"), ("selu", "identity"))


# the recipes' CLI flags (besides --n-epochs and --experiment-name), as
# their scripts give them; each config is the port's build_config of them,
# through the experiment module's own parser
CLIS = {"black_scholes": ebs, "ornstein_uhlenbeck": eou, "heston": ehe,
        "hybrid_ou_bs": ehy}
RECIPE_FLAGS = {
    # experiment_black_scholes.py's CLI defaults
    "default": [],
    # scripts/run_black_scholes.sh
    "production": ["--n-train", "10000", "--n-val", "2000", "--batch-size",
                   "256", "--hidden-dim", "50", "--learning-rate", "0.001",
                   "--num-moments", "2", "--moment-weights", "1.0", "15.0",
                   "--obs-fraction", "0.1", "--dt-ode-step", "0.01",
                   "--shared-network", "--print-every", "5"],
    # scripts/run_scaled_sweep.sh
    "scaled": ["--n-train", "100000", "--n-val", "5000", "--batch-size",
               "4096", "--hidden-dim", "256", "--obs-fraction", "0.02",
               "--num-moments", "2", "--kernels", "step", "--obs-only",
               "auto", "--print-every", "5"],
}


def recipe_config(recipe: str, n_epochs: int, name: str, *extra: str,
                  process: str = "black_scholes") -> dict:
    """The config the process's experiment CLI makes from a recipe's flags,
    ``extra`` flags after them, ``--n-epochs`` and ``--experiment-name``
    (njode_tpu_torch.experiments: build_config, obs_only resolved as
    --obs-only auto does, --kernels auto is use_pallas 'auto')."""
    cli = CLIS[process]
    args = cli.parse_args([*RECIPE_FLAGS[recipe], *extra, "--n-epochs",
                           str(n_epochs), "--experiment-name", name])
    return cli.configure(args)[0]


def default_config(n_epochs: int, name: str) -> dict:
    """The CLI defaults of experiment_black_scholes (hidden 32, two
    networks, batch 128, 1,000 / 200 obs-only trajectories)."""
    return recipe_config("default", n_epochs, name)


def train_data(dev: torch.device, n_traj: int, bs: int, seed: int,
               n_valid=None, obs_fraction: float = 0.1,
               process: str = "black_scholes") -> torch.Tensor:
    """Packed kernel rows of fresh trajectories of a 1-d family at its
    default recipe's parameters (FAMILY_PARAMS; obs-only where the family
    has an exact sampler; N = 100 obs_fraction slots), the last n_traj -
    n_valid rows padding that repeats row 0, as the Trainer pads its last
    minibatch."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = simulate_batch(n_traj, process, obs_fraction,
                       supports_obs_only(process), generator=gen, device=dev,
                       **FAMILY_PARAMS[process])
    n_valid = n_traj if n_valid is None else n_valid
    valid = torch.arange(n_traj, device=dev) < n_valid
    times = torch.where(valid[:, None], b.times, b.times[:1])
    values = torch.where(valid[:, None, None], b.values, b.values[:1])
    return tk.pack_minibatches(times, values, valid, bs)


def train_kwargs(K: int, method: str = "direct", act: str = "relu",
                 scale: str = "identity") -> dict:
    return dict(n_slots=TRAIN_N, num_moments=K, batch_size=TRAIN_BS,
                activation=act, input_scaling=scale, lr=1e-3,
                weight_decay=5e-4, moment_weights=(1.0, 10.0),
                variance_method=method)


def compare_with_plain(ours, ref, where: str,
                       names=("losses", "params", "Adam m", "Adam v")
                       ) -> float:
    """The kernel's (state, losses) against the plain version's on the same
    inputs, each named tensor at RTOL / ATOL; returns the largest abs
    err."""
    pick = {"losses": lambda r: r[1], "params": lambda r: r[0].params,
            "Adam m": lambda r: r[0].m, "Adam v": lambda r: r[0].v}
    return max(assert_close(pick[n](ours), pick[n](ref), f"{n} at {where}")
               for n in names)


def bitwise_twice(run, what: str) -> None:
    """Two calls of a whole-run kernel on the same input: every output
    bitwise equal."""
    with torch.no_grad():
        one, two = run(), run()
        torch.cuda.synchronize()
    for a, b, name in zip([*one[0], one[1]], [*two[0], two[1]],
                          ("params", "Adam m", "Adam v", "powers", "losses")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two calls on the same input "
                                 f"differ in {name}")


def tolerance_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest entrywise |a - b| / (ATOL + RTOL |b|)."""
    a, b = a.cpu().double(), b.cpu().double()
    return float(((a - b).abs() / (ATOL + RTOL * b.abs())).max())


def train_kernel_case(dev: torch.device, K: int, H: int, method: str,
                      act: str, scale: str, bs: int = TRAIN_BS,
                      G: int = TRAIN_G, obs_fraction: float = 0.1,
                      seed: int = 0) -> tuple:
    """(state, data, kwargs) of one case of the training kernel: fresh
    weights, G minibatches of bs with the last a third masked."""
    model = NeuralJumpODE(
        1, H, 1, num_moments=K, activation=act, input_scaling=scale,
        device=dev, generator=torch.Generator().manual_seed(K * H + seed))
    rows = G * bs
    data = train_data(dev, rows, bs, H + K + seed, n_valid=rows - bs // 3,
                      obs_fraction=obs_fraction)
    kw = train_kwargs(K, method, act, scale)
    kw.update(n_slots=data.shape[1] // 2, batch_size=bs)
    return tk.init_train_state(model), data, kw


def train_kernel_phase(dev: torch.device) -> float:
    """Rows 11-12 against fused_train_run_reference on the card: K x H in
    (32, 64, 128) x method x ACT_PAIRS at the default shape, then H 50 (the
    wrapper's zero padding), batch 1, 13 and 1,024 (chunked shares), H 128
    at N 25 (the slots in device memory), each at RTOL / ATOL, and H 128 at
    batch 1,024 (chunked shares at four columns a lane; its params held
    normwise); then two calls bitwise equal at the default shape."""
    worst, cases = 0.0, []
    for K in (1, 2):
        for H in (32, 64, 128):
            for method in ("direct", "second_moment"):
                cases += [dict(K=K, H=H, method=method, act=a, scale=s)
                          for a, s in ACT_PAIRS]
    relu = dict(act="relu", scale="identity")
    cases += [dict(K=K, H=50, method=m, **relu) for K in (1, 2)
              for m in ("direct", "second_moment")]
    cases += [dict(K=2, H=H, method="direct", bs=bs, **relu)
              for H, bs in ((32, 1), (32, 13), (50, 13), (32, 1024))]
    cases += [dict(K=2, H=128, method="direct", obs_fraction=0.25, G=2,
                   **relu)]
    # The widest, H 128 at batch 1,024 (2 steps): losses, m and v at RTOL /
    # ATOL, the params within GRAD_RTOL of their norm.  Among 19,456 rows a
    # relu pre-activation within rounding of zero can turn the other way
    # under another product order; where it feeds a gradient entry near
    # 1e-8, that entry changes by a large part of itself, and Adam,
    # dividing the entry by its own size, moves the parameter by up to lr.
    # The shares of the entrywise tolerance are printed (PERF.md section 6)
    wide = dict(K=2, H=128, method="direct", bs=1024, G=2, **relu)
    plans, shares = {}, ()
    for c in cases + [wide]:
        state, data, kw = train_kernel_case(dev, **c)
        plan = tk.launch_plan(c["H"], kw["n_slots"], kw["batch_size"],
                              c["scale"], c["K"])
        plans[(c["H"], kw["n_slots"], kw["batch_size"])] = tuple(plan)
        with torch.no_grad():
            ours = tk.fused_train_run(state, data, **kw)
            torch.cuda.synchronize()
            ref = tk.fused_train_run_reference(state, data, **kw)
        where = f"{c} (plan {plan})"
        if c is not wide:
            worst = max(worst, compare_with_plain(ours, ref, where))
            continue
        worst = max(worst, compare_with_plain(
            ours, ref, where, ("losses", "Adam m", "Adam v")),
            assert_close_norm(ours[0].params, ref[0].params,
                              f"params at {where}"))
        with torch.no_grad():
            r64 = tk.fused_train_run_reference(
                tk.TrainState(*(x.double() for x in state)), data.double(),
                **kw)
        shares = (tolerance_share(ours[0].params, ref[0].params),
                  tolerance_share(ref[0].params, r64[0].params))
    state, data, kw = train_kernel_case(dev, 2, 32, "direct", "relu",
                                        "identity", seed=9)
    bitwise_twice(lambda: tk.fused_train_run(state, data, **kw),
                  "training kernel")
    print(f"training kernel vs plain: {len(cases)} cases (K in (1, 2) x H in "
          f"(32, 64, 128) x direct/second_moment x relu/identity, tanh/tanh, "
          f"selu/identity at N={TRAIN_N}, batch {TRAIN_BS}, {TRAIN_G} steps; "
          f"H 50 x K x method; batch 1, 13 and 1,024; H 128 at N 25, 2 "
          f"steps; last minibatch a third masked): losses, params, m, v at "
          f"rtol {RTOL} / atol {ATOL}; H 128 at batch 1,024, 2 steps: "
          f"losses, m, v so, the params within {GRAD_RTOL} of their norm "
          f"(their largest entrywise error {shares[0]:.2f} of the tolerance "
          f"from the plain version's, the plain version's {shares[1]:.2f} "
          f"from its float64 run); max abs err {worst:.3e}; two calls "
          f"bitwise equal; plans by (H, N, batch) (blocks, trajectories a "
          f"block, warps a chain, warps, staged, slots in device memory, "
          f"smem bytes, padded H) {plans}", flush=True)
    return worst


def training_path_phase(dev: torch.device, tmp: Path) -> None:
    """run_experiment of the default config, 5 epochs then a resume to 7;
    one epoch through the kernel and the composed path from the same
    weights.  The caller resets the launch count before."""
    cfg = default_config(5, "default_bs")
    res = run_experiment(cfg, save_dir=str(tmp))
    torch.cuda.synchronize()
    after5 = tk.LAUNCHES
    hist = res["history"]["train_loss"]
    if after5 != 5 or len(hist) != 5:
        raise AssertionError(f"5 epochs gave {after5} kernel launches and "
                             f"{len(hist)} losses; expected 5 and 5")
    if not all(math.isfinite(x) for x in hist + res["history"]["val_loss"]):
        raise AssertionError(f"non-finite losses {hist}")
    run = tmp / "default_bs"
    for name in ("config.json", "model.ckpt", "history.json"):
        if not (run / name).is_file():
            raise AssertionError(f"run_experiment wrote no {name}")
    res7 = run_experiment(default_config(7, "default_bs"), save_dir=str(tmp))
    torch.cuda.synchronize()
    hist7 = json.loads((run / "history.json").read_text())["train_loss"]
    if tk.LAUNCHES != 7 or len(hist7) != 7 or hist7[:5] != hist:
        raise AssertionError(f"the resume to 7 epochs gave {tk.LAUNCHES} "
                             f"launches in all and {len(hist7)} losses")
    print(f"default training path: run_experiment (hidden 32, K=2 separate, "
          f"batch 128, 1,000 fresh obs-only BS trajectories per epoch) 5 "
          f"epochs: train loss {hist[0]:.4f} -> {hist[-1]:.4f}, val "
          f"{res['history']['val_loss'][-1]:.4f}, kernel launches {after5}; "
          f"resumed to 7 epochs (loss {res7['final_train_loss']:.4f}), "
          f"launches {tk.LAUNCHES}", flush=True)


def kernel_vs_composed_phase(dev: torch.device) -> float:
    """One epoch of identical packed data (1,000 trajectories, 8 steps)
    through the kernel and through apply_loss + autograd + Adam."""
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(5))
    data = train_data(dev, 1024, TRAIN_BS, 11, n_valid=1000)
    err = kernel_vs_composed(model, data)
    print(f"kernel vs composed path: one epoch (8 steps) from identical "
          f"weights, per-step losses and params max abs err {err:.3e}",
          flush=True)
    return err


def kernel_vs_composed(model: NeuralJumpODE, data: torch.Tensor) -> float:
    """One epoch of packed data (minibatches of TRAIN_BS rows of N =
    TRAIN_N slots, weights [1, 10]) through rows 11-12 and through
    apply_loss + autograd + Adam from the model's weights: the per-step
    losses and the params after the epoch at RTOL / ATOL."""
    kw = train_kwargs(2)
    with torch.no_grad():
        state, k_losses = tk.fused_train_run(tk.init_train_state(model),
                                             data, **kw)
    opt = make_adam(model.parameters(), 1e-3, 5e-4)
    c_losses = []
    N = TRAIN_N
    for g in range(data.shape[0] // TRAIN_BS):
        rows = data[g * TRAIN_BS:(g + 1) * TRAIN_BS]
        opt.zero_grad()
        loss = model.apply_loss(
            rows[:, N:2 * N], rows[:, :N, None], traj_mask=rows[:, 2 * N] > 0,
            ignore_first_continuity=True, moment_weights=[1.0, 10.0])
        loss.backward()
        opt.step()
        c_losses.append(loss.detach())
    err = assert_close(k_losses, torch.stack(c_losses),
                       "kernel vs composed per-step losses")
    ref = tk.init_train_state(model).params
    return max(err, assert_close(state.params, ref,
                                 "kernel vs composed params after an epoch"))


def val_metrics(model: NeuralJumpODE, dev: torch.device,
                mw=(1.0, 10.0), n: int = 200,
                obs_fraction: float = 0.1) -> tuple:
    """bench.py:435-455: n fresh grid-simulated trajectories; MSE of the
    before-jump mean and variance (direct: W^2) against the closed-form
    truths past slot 0, and the relative loss."""
    gen = torch.Generator(device=dev).manual_seed(7)
    vb = simulate_batch(n, "black_scholes", obs_fraction, generator=gen,
                        device=dev, mu=0.1, sigma=0.5, x0=1.0)
    with torch.no_grad():
        preds, before = model.apply(vb.times, vb.values, vb.mask)
        yt, ytb = moments_at_obs(vb.times, vb.values, "black_scholes",
                                 num_moments=2, mu=0.1, sigma=0.5)
        mse_mean = float(((before[:, 1:, :, 0] - ytb[:, 1:, :, 0]) ** 2).mean())
        mse_var = float(((before[:, 1:, :, 1] ** 2 - ytb[:, 1:, :, 1]) ** 2)
                        .mean())
        L_model = float(nj_ode_loss_dense(vb.values, preds, before, vb.mask,
                                          moment_weights=list(mw)))
        L_true = float(nj_ode_loss_dense(vb.values, yt, ytb, vb.mask,
                                         moment_weights=list(mw)))
    return mse_mean, mse_var, (L_model - L_true) / max(L_true, 1e-8)


def training_times_phase(dev: torch.device, card: str, tmp: Path) -> tuple:
    """Phase 10.  Returns (kernel ms per epoch call, plain ms per epoch
    call, bound ms per epoch call, bound_by)."""
    E, n = TRAIN_EPOCHS, 1000
    # the whole recipe through Trainer.train with the kernel
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], use_train_kernel=True)
    cfg = default_config(E, "timed")
    train_fn, val_fn = create_data_loaders(base_seed=1, device=dev,
                                           **cfg["data"])
    torch.cuda.synchronize()
    tk.LAUNCHES = 0
    t0 = time.perf_counter()
    hist = trainer.train(train_fn, val_fn, n_epochs=E, batch_size=128,
                         print_every=E, config=cfg)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    print(f"default recipe ({E} epochs): launches of the whole-run training "
          f"kernel (rows 11-12) {tk.LAUNCHES}", flush=True)
    mse_mean, mse_var, rel = val_metrics(model, dev)

    # one epoch's kernel call and its plain version, CUDA events
    data = train_data(dev, 1024, TRAIN_BS, 3, n_valid=n)
    state = tk.init_train_state(model)
    kw = train_kwargs(2)
    with torch.no_grad():
        run_k = lambda: tk.fused_train_run(state, data, **kw)
        run_p = lambda: tk.fused_train_run_reference(state, data, **kw)
        p_ms = time_ms(run_p, warmup=2, reps=5)
        k_ms = time_ms(run_k, warmup=2, reps=10)
        k2_ms = time_ms(run_k, warmup=0, reps=10)
        p2_ms = time_ms(run_p, warmup=0, reps=5)
    # bench.py:468-481's count: forward matmul flops x 3, valid trajectories
    H, K, S = 32, 2, TRAIN_N - 1
    fwd = K * 2 * (TRAIN_N * (H + H * H) + (2 * TRAIN_N - 1) * (H * H + H)
                   + S * ((H + 3) * H + H * H))
    P = tk.n_params_per_net(H)
    epoch_bytes = 4 * (data.numel() + 2 * 3 * K * P + 2 * 2
                       + data.shape[0] // TRAIN_BS)
    bound_ms, bound_by = bound_of(3 * fwd * n, epoch_bytes)

    # the recipe as one call over all epochs' packed data (bench.py's way)
    all_data = torch.cat([train_data(dev, 1024, TRAIN_BS, 100 + e, n_valid=n)
                          for e in range(E)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    with torch.no_grad():
        start.record()
        _, losses = tk.fused_train_run(tk.init_train_state(model), all_data,
                                       **kw)
        end.record()
        end.synchronize()
    one_call_ms = start.elapsed_time(end)
    if not torch.isfinite(losses).all():
        raise AssertionError("non-finite losses in the one-call recipe")

    # the composed path through Trainer.train, with the kernel arm's
    # validation and relative loss, and the plain version over packed
    # epochs: each warmed by one epoch, then COMPARED_EPOCHS timed and
    # scaled to E
    comp = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                         generator=torch.Generator().manual_seed(0))
    comp_tr = Trainer(comp, make_adam(comp.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], use_train_kernel=False)
    comp_tr.train(train_fn, val_fn, n_epochs=1, batch_size=128,
                  print_every=E, config=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp_tr.train(train_fn, val_fn, n_epochs=COMPARED_EPOCHS, batch_size=128,
                  print_every=E, config=cfg)
    torch.cuda.synchronize()
    comp_s = (time.perf_counter() - t0) * E / COMPARED_EPOCHS
    with torch.no_grad():
        st = tk.init_train_state(comp)
        st, _ = tk.fused_train_run_reference(st, all_data[:1024], **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(COMPARED_EPOCHS):
            st, _ = tk.fused_train_run_reference(
                st, all_data[e * 1024:(e + 1) * 1024], **kw)
        torch.cuda.synchronize()
    plain_s = (time.perf_counter() - t0) * E / COMPARED_EPOCHS
    step_ms = statistics.median([k_ms, k2_ms]) / (1024 // TRAIN_BS)
    print(f"training times on {card}: default recipe ({E} epochs x {n} fresh "
          f"trajectories) through Trainer.train with the kernel "
          f"{trainer_s:.3f} s = {E * n / trainer_s:.0f} traj/s (final train "
          f"loss {hist['train_loss'][-1]:.4f}); as one fused_train_run over "
          f"all epochs' packed data {one_call_ms / 1e3:.3f} s = "
          f"{E * n / (one_call_ms / 1e3):.0f} traj/s; composed path through "
          f"Trainer.train ({COMPARED_EPOCHS} epochs after one warm-up, scaled "
          f"to {E}): {comp_s:.3f} s = {E * n / comp_s:.0f} traj/s; plain "
          f"version ({COMPARED_EPOCHS} epoch calls after one, scaled): "
          f"{plain_s:.3f} s", flush=True)
    print(f"training kernel on {card}: one epoch call (8 steps, 1,024 rows) "
          f"{k_ms:.3f} / {k2_ms:.3f} ms = {step_ms:.4f} ms per step, plain "
          f"version {p_ms:.3f} / {p2_ms:.3f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}); val MSE mean {mse_mean:.3e} var {mse_var:.3e}, "
          f"relative loss {rel:.4f}", flush=True)
    return (statistics.median([k_ms, k2_ms]), statistics.median([p_ms, p2_ms]),
            bound_ms, bound_by)


# ------------------------------------------------------ production training

PROD_H, PROD_N, PROD_BS, PROD_M, PROD_DT = 50, 10, 256, 100, 0.01
PROD_MW = (1.0, 15.0)
PROD_TRAIN, PROD_VAL = 10_000, 2_000
PROD_EPOCHS = 200
PROD_BUDGET_S = 90.0         # the kernel arm runs all epochs if they fit
WALK_ACTS = (("relu", "identity"), ("tanh", "tanh"), ("selu", "identity"))


def production_config(n_epochs: int, name: str) -> dict:
    """scripts/run_black_scholes.sh's flags (10,000 / 2,000 trajectories,
    batch 256, hidden 50, lr 1e-3, two moments weighted [1, 15], obs
    fraction 0.1, dt_ode_step 0.01, shared network, print every 5) and the
    CLI's other defaults (--kernels auto, --grid-walk auto)."""
    return recipe_config("production", n_epochs, name)


def walk_case(gen: torch.Generator, K: int, B: int, d: int,
              dev: torch.device) -> dict:
    """Grid slots (10 per row, slot 0 at t = 0) over M = 100 cells, every
    third row ending at t = T (cell M) and two rows ragged; jump states,
    ODEFunc weights (torch's default law) and an output cotangent."""
    N, M = PROD_N, PROD_M
    cells = torch.sort(torch.stack([torch.cat([
        torch.zeros(1), torch.randperm(M - 1, generator=gen)[:N - 1] + 1.0])
        for _ in range(B)]), dim=1).values
    cells[::3, -1] = M
    mask = torch.ones(B, N, dtype=torch.bool)
    for b, n in ((1 % B, 6), (2 % B, 8)):
        mask[b, n:] = False
        cells[b, n:] = cells[b, n - 1]

    def uni(*shape):
        return (torch.rand(shape, generator=gen) * 2 - 1) / shape[-1] ** 0.5
    case = {"times": cells * PROD_DT, "mask": mask,
            "x": torch.exp(torch.randn(B, N, 1, generator=gen) * 0.3),
            "hj": torch.randn(K, B, N, d, generator=gen) * 0.5,
            "w": [uni(K, d, d + 3), uni(K, d), uni(K, d, d), uni(K, d)],
            "ct": torch.randn(K, B * (N - 1), d, generator=gen)}
    return {k: ([w.to(dev) for w in v] if k == "w" else v.to(dev))
            for k, v in case.items()}


def walk_run(c: dict, act: str, scale: str, fn, grad: bool = True):
    """h_minus and, with ``grad``, the cotangents of h_jump and the four
    weights through ``fn`` (walk_gaps_fused or walk_gaps_reference)."""
    sc = {"identity": lambda v: v, "tanh": torch.tanh}[scale]
    hj = c["hj"].detach().requires_grad_(grad)
    w = [x.detach().requires_grad_(grad) for x in c["w"]]
    g_idx = torch.round(c["times"] / PROD_DT).long()
    with torch.set_grad_enabled(grad):
        out = fn(hj, sc(c["x"]), c["times"], c["mask"], g_idx, w, PROD_DT,
                 PROD_M, act, scale)
        if not grad:
            return [out]
        return [out.detach()] + list(torch.autograd.grad(out, [hj, *w],
                                                         c["ct"]))


GRAD_RTOL = 1e-3
# rows 4-5 against the plain pair of their own data flow
# (gap_bwd_records_reference: the kernel's counts, order, records and sum
# order), each output's error/norm: the pair forms each product in another
# order, so a relu or selu kink within rounding of zero can turn the other
# way (readings on the H100 up to 2.6e-5 over gap_train_kernel_phase's cases)
RECORDS_RTOL = 1e-4
# rows 7 and 8's kernels (csrc/walk_scan.cu), held to 0 spill bytes by phase
# 11, and row 4-5's (csrc/gap_train.cu) by phase 20
WALK_KERNELS = ("walk_fwd_kernel", "walk_bwd_kernel", "walk_dw_kernel",
                "walk_reduce_kernel")
GAP_TRAIN_KERNELS = ("gap_fwd_kernel", "gap_bwd_kernel")


def assert_close_norm(a, b, what: str, rtol: float = GRAD_RTOL) -> float:
    """||a - b|| <= rtol ||b|| (Frobenius); returns the largest abs err.
    For gradients through the walk an entrywise bound does not hold: they
    run back through up to 100 compounded cells, where a relu (or selu)
    kink at a pre-activation within rounding of zero turns the other way
    under another summation order and moves isolated entries; at 2,000
    rows that reaches 1e-4 of the norm."""
    a, b = a.cpu().double(), b.cpu().double()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")
    rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
    if rel > rtol:
        raise AssertionError(f"{what}: relative error {rel:.3e} beyond "
                             f"rtol={rtol} (max abs err "
                             f"{float((a - b).abs().max()):.3e})")
    return float((a - b).abs().max())


def walk_kernel_phase(dev: torch.device) -> tuple[float, float]:
    """Rows 7-8 against walk_gaps_reference on the card: forward h_minus and
    every backward cotangent, act/scaling x K_h x d_h x rows, ragged rows
    and endpoint slots in every case."""
    gen = torch.Generator().manual_seed(21)
    worst_f = worst_b = 0.0
    n = 0
    for d in (12, 50, 125):
        for B in (16, 256, 2000):
            for K in (1, 2):
                for act, scale in WALK_ACTS:
                    c = walk_case(gen, K, B, d, dev)
                    ours = walk_run(c, act, scale, walk_scan.walk_gaps_fused)
                    ref = walk_run(c, act, scale,
                                   walk_scan.walk_gaps_reference)
                    torch.cuda.synchronize()
                    where = f"d_h={d} B={B} K={K} {act}/{scale}"
                    worst_f = max(worst_f, assert_close(
                        ours[0], ref[0], f"walk h_minus at {where}"))
                    for name, a, b in zip(("h_jump", "W1", "b1", "W2", "b2"),
                                          ours[1:], ref[1:]):
                        worst_b = max(worst_b, assert_close_norm(
                            a, b, f"walk d{name} at {where}"))
                    n += 1
    # the production shape (256 rows, H 50), K_h 1 and 2, and 384 rows at
    # K_h 2 (768 walk rows: 2 warps a row, the record writes split between
    # them): the kernels against the explicit plain pair of their data flow
    # (residuals, the backward's records, the weight sums in chunk order),
    # and two backward calls bitwise equal (the sums run in a fixed order)
    plans = []
    for K, B in ((1, PROD_BS), (2, PROD_BS), (2, 384)):
        c = walk_case(gen, K, B, PROD_H, dev)
        ours = walk_run(c, "relu", "identity", walk_scan.walk_gaps_fused)
        again = walk_run(c, "relu", "identity", walk_scan.walk_gaps_fused)
        torch.cuda.synchronize()
        g_idx = torch.round(c["times"] / PROD_DT).long()
        with torch.no_grad():
            ref = walk_scan.walk_vjp_reference(
                c["hj"], c["x"], c["times"], c["mask"], g_idx, c["w"],
                PROD_DT, PROD_M, "relu", "identity", c["ct"])
        where = f"H {PROD_H}, {B} rows, K_h={K}, vs the records' plain pair"
        worst_f = max(worst_f, assert_close(ours[0], ref[0],
                                            f"walk h_minus at {where}"))
        for name, a, b in zip(("h_jump", "W1", "b1", "W2", "b2"), ours[1:],
                              ref[1]):
            worst_b = max(worst_b, assert_close_norm(
                a, b, f"walk d{name} at {where}"))
        for name, a, b in zip(("h_minus", "h_jump", "W1", "b1", "W2", "b2"),
                              ours, again):
            if not torch.equal(a, b):
                raise AssertionError(f"rows 7-8 at {B} rows, K_h={K}: two "
                                     f"calls differ in {name}")
        plans.append(tuple(walk_scan.walk_bwd_plan(PROD_H, B, PROD_N,
                                                   PROD_M, K)))
        n += 1
    # row 7 where walk_fwd_plan's warps a row switch (512 / 513 and 1,024 /
    # 1,025 walk rows), the forward alone against the plain version, and two
    # forward calls bitwise equal
    switch = []
    for B in (512, 513, 1024, 1025):
        c = walk_case(gen, 1, B, PROD_H, dev)
        ours = walk_run(c, "relu", "identity", walk_scan.walk_gaps_fused,
                        grad=False)
        again = walk_run(c, "relu", "identity", walk_scan.walk_gaps_fused,
                         grad=False)
        ref = walk_run(c, "relu", "identity", walk_scan.walk_gaps_reference,
                       grad=False)
        torch.cuda.synchronize()
        worst_f = max(worst_f, assert_close(
            ours[0], ref[0], f"walk h_minus at {B} rows (row 7's plan)"))
        if not torch.equal(ours[0], again[0]):
            raise AssertionError(f"row 7 at {B} rows: two calls differ")
        switch.append((B, walk_scan.walk_fwd_plan(PROD_H, B, PROD_N, PROD_M,
                                                  1).wpt))
        n += 1
    print(f"walk kernels vs plain: {n} cases (d_h in (12, 50, 125) x rows in "
          f"(16, 256, 2000) x K_h in (1, 2) x relu/identity, tanh/tanh, "
          f"selu/identity; M={PROD_M}, N={PROD_N}, ragged rows and slots at "
          f"t=T; then the production shape at K_h 1 and 2, and 384 rows at "
          f"K_h 2, against the plain pair of the records' data flow; the "
          f"forward alone at 512, 513, 1,024 and 1,025 rows, K_h 1, where "
          f"row 7's warps a row switch: {switch}): "
          f"forward max abs err "
          f"{worst_f:.3e} (rtol {RTOL} / atol {ATOL}); backward (h_jump, W1, "
          f"b1, W2, b2) max abs err {worst_b:.3e} (each within {GRAD_RTOL} "
          f"of its norm); two calls bitwise equal at those seven shapes; "
          f"backward plans (warps a row, warps a block, rows a chunk, "
          f"chunks, shared bytes) {plans}", flush=True)
    return worst_f, worst_b


def walk_train_kwargs(K: int, method: str, solver: str, bs: int,
                      hidden: int = PROD_H) -> dict:
    return dict(n_slots=PROD_N, num_moments=K, batch_size=bs,
                hidden_dim=hidden, dt_ode_step=PROD_DT, max_substeps=PROD_M,
                lr=1e-3, weight_decay=5e-4, moment_weights=PROD_MW[:K],
                variance_method=method, ode_solver=solver)


def walk_model(dev, K: int = 2, solver: str = "euler", seed: int = 0,
               grid_walk: bool = True, hidden: int = PROD_H) -> NeuralJumpODE:
    return NeuralJumpODE(1, hidden, 1, num_moments=K, shared_network=True,
                         dt_ode_step=PROD_DT, t_max=1.0, ode_solver=solver,
                         grid_walk=grid_walk, device=dev,
                         generator=torch.Generator().manual_seed(seed))


# the widest shape the walk-train gate admits: its step buffer runs in chunks
# of cells and O1 takes J2's plane of shared memory
WIDE_H, WIDE_BS = 128, 1024


def walk_train_phase(dev: torch.device) -> float:
    """Row 13 against fused_walk_train_run_reference on the card: 8 steps
    at the production shape, then K x solver x variance method over 3 steps
    of batch 64, then 2 steps at the widest shape the gate admits (H 128,
    batch 1,024, rk4); the last minibatch trajectory-masked in each.  Then
    two calls at the production shape, bitwise equal."""
    worst, n = 0.0, 0
    cases = [(2, "direct", "euler", PROD_BS, 8, PROD_H)]
    cases += [(K, method, solver, 64, 3, PROD_H) for K in (1, 2)
              for solver in ("euler", "heun", "rk4")
              for method in ("direct", "second_moment")]
    cases += [(2, "direct", "rk4", WIDE_BS, 2, WIDE_H)]
    for K, method, solver, bs, G, hidden in cases:
        model = walk_model(dev, K, solver, seed=K + G, hidden=hidden)
        data = train_data(dev, G * bs, bs, 31 + n, n_valid=G * bs - bs // 3)
        kw = walk_train_kwargs(K, method, solver, bs, hidden)
        state = wt.init_walk_state(model)
        with torch.no_grad():
            ours = wt.fused_walk_train_run(state, data, **kw)
            torch.cuda.synchronize()
        ref = wt.fused_walk_train_run_reference(state, data, **kw)
        where = (f"walk-train K={K} {method} {solver} H={hidden} batch {bs} "
                 f"(plan {tuple(wt.launch_plan(hidden, bs, PROD_N, solver, PROD_M))})")
        worst = max(worst, assert_close(ours[1], ref[1], f"losses at {where}"),
                    assert_close(ours[0].params, ref[0].params,
                                 f"params at {where}"))
        for a, b, what in ((ours[0].m, ref[0].m, "Adam m"),
                           (ours[0].v, ref[0].v, "Adam v")):
            worst = max(worst, assert_close_norm(a, b, f"{what} at {where}"))
        n += 1
    model = walk_model(dev, 2, "euler", seed=9)
    data = train_data(dev, 8 * PROD_BS, PROD_BS, 77,
                      n_valid=8 * PROD_BS - PROD_BS // 3)
    kw = walk_train_kwargs(2, "direct", "euler", PROD_BS)
    state = wt.init_walk_state(model)
    bitwise_twice(lambda: wt.fused_walk_train_run(state, data, **kw),
                  "walk-train")
    print(f"walk-train kernel vs plain: {n} cases (8 steps at H={PROD_H}, "
          f"N={PROD_N}, batch {PROD_BS}, M={PROD_M}; K in (1, 2) x euler/"
          f"heun/rk4 x direct/second_moment at batch 64, 3 steps; 2 steps "
          f"at H={WIDE_H}, batch {WIDE_BS}, rk4, chunked; last minibatch a "
          f"third masked): losses and params at rtol {RTOL} / atol {ATOL}, "
          f"Adam m and v each within {GRAD_RTOL} of its norm; max abs err "
          f"{worst:.3e}; two calls bitwise equal", flush=True)
    return worst


def production_path_phase(dev: torch.device, tmp: Path) -> None:
    """run_experiment of the production config, 3 epochs then a resume to
    5.  The caller sets the launch counts to 0 before and reads them after:
    every step goes through the walk-train kernel, and validation (a walk
    without autograd) takes the per-gap route with the gap kernel, so the
    walk kernels do not launch here."""
    res = run_experiment(production_config(3, "production_bs"),
                         save_dir=str(tmp))
    torch.cuda.synchronize()
    hist = res["history"]["train_loss"]
    after3 = wt.LAUNCHES
    if after3 != 3 or len(hist) != 3:
        raise AssertionError(f"3 production epochs gave {after3} walk-train "
                             f"launches and {len(hist)} losses")
    if not all(math.isfinite(x) for x in hist + res["history"]["val_loss"]):
        raise AssertionError(f"non-finite production losses {hist}")
    res5 = run_experiment(production_config(5, "production_bs"),
                          save_dir=str(tmp))
    torch.cuda.synchronize()
    hist5 = res5["history"]["train_loss"]
    if wt.LAUNCHES != 5 or len(hist5) != 5 or hist5[:3] != hist:
        raise AssertionError(f"the resume to 5 epochs gave {wt.LAUNCHES} "
                             f"launches in all and {len(hist5)} losses")
    if walk_scan.LAUNCHES_FWD or walk_scan.LAUNCHES_BWD or not gap_scan.LAUNCHES:
        raise AssertionError(
            f"production validation launched the walk kernels "
            f"{walk_scan.LAUNCHES_FWD}/{walk_scan.LAUNCHES_BWD} times and the "
            f"gap kernel {gap_scan.LAUNCHES} times (expected 0/0 and > 0)")
    print(f"production training path: run_experiment (hidden {PROD_H}, "
          f"shared, K=2, dt {PROD_DT}, batch {PROD_BS}, {PROD_TRAIN:,} fresh "
          f"trajectories per epoch, {PROD_VAL:,} validation) 3 epochs: train "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}, val "
          f"{res['history']['val_loss'][-1]:.4f}; resumed to 5 (loss "
          f"{hist5[-1]:.4f}); launches in this window: walk-train "
          f"{wt.LAUNCHES}, gap kernel (per-gap validation) "
          f"{gap_scan.LAUNCHES}, walk forward/backward "
          f"{walk_scan.LAUNCHES_FWD}/{walk_scan.LAUNCHES_BWD}", flush=True)


def composed_grid_walk_phase(dev: torch.device) -> None:
    """One epoch of Trainer.train on the composed grid-walk path
    (use_train_kernel=False: apply_loss with the walk kernels under
    autograd, torch.optim.Adam): the path of rows 7-8.  The caller sets the
    launch counts to 0 before and reads them after."""
    cfg = production_config(1, "composed")
    model = walk_model(dev, seed=3)
    trainer = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True,
                      moment_weights=list(PROD_MW), use_train_kernel=False)
    train_fn, _ = create_data_loaders(base_seed=5, device=dev, **cfg["data"])
    comp = trainer.train(train_fn, n_epochs=1, batch_size=PROD_BS,
                         print_every=5)
    torch.cuda.synchronize()
    steps = -(-PROD_TRAIN // PROD_BS)
    if (walk_scan.LAUNCHES_FWD != steps or walk_scan.LAUNCHES_BWD != steps
            or wt.LAUNCHES or not math.isfinite(comp["train_loss"][0])):
        raise AssertionError(
            f"the composed grid-walk epoch launched the walk kernels "
            f"{walk_scan.LAUNCHES_FWD}/{walk_scan.LAUNCHES_BWD} times "
            f"(expected {steps} each) and the walk-train kernel "
            f"{wt.LAUNCHES} times, loss {comp['train_loss'][0]}")
    print(f"composed grid-walk path: Trainer.train, one epoch of "
          f"{PROD_TRAIN:,} trajectories ({steps} steps of {PROD_BS}), loss "
          f"{comp['train_loss'][0]:.4f}; launches in this window: walk "
          f"forward {walk_scan.LAUNCHES_FWD}, backward "
          f"{walk_scan.LAUNCHES_BWD}, walk-train {wt.LAUNCHES}", flush=True)


def separate_grid_walk_path_phase(dev: torch.device, tmp: Path) -> dict:
    """run_experiment of the production config without --shared-network
    (two ODE networks, K_h 2) under the CLI's default --kernels auto, 2
    epochs then a resume to 3: the walk-train kernel needs a shared network,
    so "auto" walks the grid with rows 7 and 8 under autograd, once a step
    each, and validation takes row 1.  The caller resets the counts before;
    returns the window's counts by row."""
    def cfg(n):
        c = production_config(n, "separate_walk")
        c["shared_network"] = False
        return c
    res = run_experiment(cfg(2), save_dir=str(tmp))
    hist = res["history"]["train_loss"]
    res3 = run_experiment(cfg(3), save_dir=str(tmp))
    torch.cuda.synchronize()
    hist3 = res3["history"]["train_loss"]
    if (len(hist3) != 3 or hist3[:2] != hist or not all(
            math.isfinite(x) for x in hist3 + res3["history"]["val_loss"])):
        raise AssertionError(f"separate-network grid walk: losses {hist} then "
                             f"{hist3}")
    got = expect_counts("separate-network grid walk (--kernels auto)",
                        {1: None, 7: 3 * PROD_STEPS, 8: 3 * PROD_STEPS})
    print(f"separate-network grid-walk path: run_experiment (production "
          f"config without --shared-network, K_h 2, --kernels auto) 2 epochs "
          f"then resumed to 3: train loss {hist3[0]:.4f} -> {hist3[-1]:.4f}; "
          f"launches in this window: walk forward {got[7]}, backward "
          f"{got[8]} (once a step), walk-train {got[13]}, gap kernel "
          f"(validation) {got[1]}", flush=True)
    return got


def walk_twin_vs_composed_phase(dev: torch.device) -> float:
    """One epoch of identical packed data (2,560 trajectories, 10 steps of
    256, the last a third masked) through the walk-train kernel and through
    apply_loss + autograd (the walk kernels) + Adam."""
    model = walk_model(dev, seed=6)
    data = train_data(dev, 10 * PROD_BS, PROD_BS, 41,
                      n_valid=10 * PROD_BS - PROD_BS // 3)
    kw = walk_train_kwargs(2, "direct", "euler", PROD_BS)
    with torch.no_grad():
        state, k_losses = wt.fused_walk_train_run(wt.init_walk_state(model),
                                                  data, **kw)
    opt = make_adam(model.parameters(), 1e-3, 5e-4)
    c_losses = []
    N = PROD_N
    for g in range(data.shape[0] // PROD_BS):
        rows = data[g * PROD_BS:(g + 1) * PROD_BS]
        opt.zero_grad()
        loss = model.apply_loss(
            rows[:, N:2 * N], rows[:, :N, None], traj_mask=rows[:, 2 * N] > 0,
            ignore_first_continuity=True, moment_weights=list(PROD_MW))
        loss.backward()
        opt.step()
        c_losses.append(loss.detach())
    err = assert_close(k_losses, torch.stack(c_losses),
                       "walk-train kernel vs composed per-step losses")
    err = max(err, assert_close(state.params, wt.init_walk_state(model).params,
                                "walk-train kernel vs composed params"))
    print(f"walk-train kernel vs composed grid-walk path: one epoch (10 "
          f"steps) from identical weights, losses and params max abs err "
          f"{err:.3e}", flush=True)
    return err


def walk_flops_per_row(d: int, M: int) -> float:
    """The walk's forward products per row and network: 2 M ((d+3) d + d^2)
    (the backward counts twice that)."""
    return 2.0 * M * ((d + 3) * d + d * d)


def timed_epochs(trainer, train_fn, val_fn, cfg, n: int,
                 batch_size: int = PROD_BS) -> float:
    """Seconds of one Trainer.train call of n epochs (epochs 0..n-1 of the
    loaders; the trainer's histories grow by n)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(train_fn, val_fn, n_epochs=n, batch_size=batch_size,
                  print_every=10_000, config=cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def production_times_phase(dev: torch.device, card: str) -> tuple:
    """Host clock around synchronized Trainer.train calls; CUDA events for
    the walk-train kernel.  Returns its (ms, plain ms, bound ms, bound_by)."""
    E = PROD_EPOCHS
    cfg = production_config(E, "timed")
    train_fn, val_fn = create_data_loaders(base_seed=1, device=dev,
                                           **cfg["data"])
    model = walk_model(dev, seed=0)
    trainer = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True,
                      moment_weights=list(PROD_MW), use_train_kernel=True)
    wt.LAUNCHES = gap_scan.LAUNCHES = 0
    first = timed_epochs(trainer, train_fn, val_fn, cfg, 3) / 3
    n_k = E - 3 if first * E <= PROD_BUDGET_S else 20
    kern_s = timed_epochs(trainer, train_fn, val_fn, cfg, n_k) * E / n_k
    print(f"production recipe ({3 + n_k} epochs run): launches of the "
          f"walk-train kernel (row 13) {wt.LAUNCHES}, of the gap kernel in "
          f"validation (row 1) {gap_scan.LAUNCHES}", flush=True)
    mse_mean, mse_var, rel = val_metrics(model, dev, PROD_MW)
    trained = len(trainer.train_losses)

    def composed_arm(grid_walk: bool) -> float:
        m = walk_model(dev, seed=0, grid_walk=grid_walk)
        tr = Trainer(m, make_adam(m.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True,
                     moment_weights=list(PROD_MW), use_train_kernel=False)
        timed_epochs(tr, train_fn, val_fn, cfg, 1)
        return timed_epochs(tr, train_fn, val_fn, cfg, 2) * E / 2
    walk_s = composed_arm(True)
    gap_s = composed_arm(False)

    # one epoch call of the kernel and of its plain version
    n_rows = -(-PROD_TRAIN // PROD_BS) * PROD_BS
    data = train_data(dev, n_rows, PROD_BS, 51, n_valid=PROD_TRAIN)
    kw = walk_train_kwargs(2, "direct", "euler", PROD_BS)
    state = wt.init_walk_state(model)
    with torch.no_grad():
        run_k = lambda: wt.fused_walk_train_run(state, data, **kw)
        k_ms = time_ms(run_k, warmup=2, reps=10)
    run_p = lambda: wt.fused_walk_train_run_reference(state, data, **kw)
    p_ms = time_ms(run_p, warmup=0, reps=1)
    with torch.no_grad():
        k2_ms = time_ms(run_k, warmup=0, reps=10)
    fwd = 2 * (PROD_N * (PROD_H + PROD_H ** 2)
               + (2 * PROD_N - 1) * (PROD_H ** 2 + 2 * PROD_H)
               + PROD_M * ((PROD_H + 3) * PROD_H + PROD_H ** 2))
    P = wt.n_params(PROD_H, 2)
    t_bound = bound_of(3 * fwd * PROD_TRAIN,
                       4 * (data.numel() + 6 * P + 4 + data.shape[0]
                            // PROD_BS))

    print(f"production times on {card}: the recipe ({E} epochs x "
          f"{PROD_TRAIN:,} fresh trajectories, batch {PROD_BS}, validation "
          f"{PROD_VAL:,}) through Trainer.train with the walk-train kernel "
          f"{kern_s:.3f} s = {E * PROD_TRAIN / kern_s:.0f} traj/s ({n_k} "
          f"epochs timed after 3 at {first:.4f} s each, scaled to {E}); "
          f"composed grid-walk path {walk_s:.3f} s = "
          f"{E * PROD_TRAIN / walk_s:.0f} traj/s; per-gap composed path "
          f"{gap_s:.3f} s = {E * PROD_TRAIN / gap_s:.0f} traj/s (each 2 "
          f"epochs after one, scaled to {E})", flush=True)
    plan = wt.launch_plan(PROD_H, PROD_BS, PROD_N, "euler", PROD_M)
    print(f"walk-train kernel on {card}: one epoch call ({n_rows // PROD_BS} "
          f"steps of {PROD_BS}; plan {tuple(plan)}) {k_ms:.3f} / "
          f"{k2_ms:.3f} ms = "
          f"{k_ms / (n_rows // PROD_BS):.4f} ms per step; plain version "
          f"{p_ms:.3f} ms; bound {t_bound[0]:.4f} ms ({t_bound[1]}); val MSE "
          f"after {trained} epochs: mean {mse_mean:.3e} var {mse_var:.3e}, "
          f"relative loss {rel:.4f}", flush=True)
    return (statistics.median([k_ms, k2_ms]), p_ms, *t_bound)


def walk_times_phase(dev: torch.device, card: str) -> dict:
    """CUDA events for rows 7-8 against their plain versions, and the
    validation A/B.  Returns each kernel's (ms, plain ms, bound ms,
    bound_by)."""
    # rows 7-8 at the shape their path launches them: a minibatch of 256
    # rows under autograd, the forward writing its residuals; K_h 2 (two
    # networks, the --kernels auto path of separate_grid_walk_path_phase)
    # and 1 (the composed walk of the shared network)
    rows_78 = {}
    for K in (1, 2):
        c_tr = walk_case(torch.Generator().manual_seed(62), K, PROD_BS,
                         PROD_H, dev)
        hj = c_tr["hj"].detach().requires_grad_()
        w = [x.detach().requires_grad_() for x in c_tr["w"]]
        g_idx = torch.round(c_tr["times"] / PROD_DT).long()

        def walk_fwd(fn):
            return fn(hj, c_tr["x"], c_tr["times"], c_tr["mask"], g_idx, w,
                      PROD_DT, PROD_M, "relu", "identity")
        f_ms = time_ms(lambda: walk_fwd(walk_scan.walk_gaps_fused))
        fp_ms = time_ms(lambda: walk_fwd(walk_scan.walk_gaps_reference),
                        warmup=1, reps=5)
        out = walk_fwd(walk_scan.walk_gaps_fused)
        b_ms = time_ms(lambda: torch.autograd.grad(out, [hj, *w], c_tr["ct"],
                                                   retain_graph=True))
        ref_out = walk_fwd(walk_scan.walk_gaps_reference)
        bp_ms = time_ms(lambda: torch.autograd.grad(ref_out, [hj, *w],
                                                    c_tr["ct"],
                                                    retain_graph=True),
                        warmup=1, reps=5)
        d, M, S, R = PROD_H, PROD_M, PROD_N - 1, PROD_BS
        per_row = walk_flops_per_row(d, M)
        w_bytes = 4 * K * (2 * d * d + 6 * d)
        # forward: h_jump, x, t, both cells and the weights in; h_minus and
        # the residuals (h, t, x per cell) out; the backward: the output
        # cotangent and the residuals in, the jump cotangent and the
        # weights' out
        f_bytes = 4 * R * (K * PROD_N * d + 4 * PROD_N + K * S * d
                           + M * (K * d + 2)) + w_bytes
        b_bytes = 4 * R * (K * S * d + M * (K * d + 2) + 2 * PROD_N
                           + K * PROD_N * d) + 2 * w_bytes
        rows_78[K] = ((f_ms, fp_ms, *bound_of(K * per_row * R, f_bytes)),
                      (b_ms, bp_ms, *bound_of(2 * K * per_row * R, b_bytes)))

    # the validation A/B behind the model's rule that a walk without
    # autograd on the card takes the per-gap route: under no_grad, on the
    # same jump states, the walk kernel alone and with the grid guard
    # (_check_grid_alignment, one host read) that the walk route of apply
    # runs before it, against the per-gap route (gap kernel), at 256 and
    # 2,000 rows
    ab = {}
    m_ab = walk_model(dev, seed=9)
    for rows in (PROD_BS, PROD_VAL):
        vb = simulate_batch(rows, "black_scholes", 0.1, True,
                            generator=torch.Generator(device=dev).manual_seed(
                                rows), device=dev, mu=0.1, sigma=0.5, x0=1.0)
        times, values = vb.times, vb.values
        B, N = times.shape
        with torch.no_grad():
            h_j = m_ab._jump(values.reshape(B * N, 1)).reshape(1, B, N, d)
            g_ab = torch.round(times / PROD_DT).long()
            h0 = h_j[:, :, :-1].reshape(1, B * (N - 1), d)

            def walk_arm():
                return walk_scan.walk_gaps_fused(
                    h_j, m_ab._scale(values), times, None, g_ab,
                    m_ab._ode_weights(), PROD_DT, PROD_M, m_ab._act_key,
                    m_ab._scale_key)

            def per_gap_arm():
                return m_ab._integrate_gap(
                    h0, values[:, :-1].reshape(-1, 1),
                    times[:, :-1].reshape(-1), times[:, 1:].reshape(-1),
                    inference=True)
            def guarded_walk_arm():
                m_ab._check_grid_alignment(times, None)
                return walk_arm()
            diff = float((walk_arm() - per_gap_arm()).abs().max())
            ab[rows] = (time_ms(walk_arm), time_ms(guarded_walk_arm),
                        time_ms(per_gap_arm), diff)
    print(f"walk kernels on {card}, at {PROD_BS} rows under autograd: "
          + "; ".join(f"K_h {K}: forward with residuals {f[0]:.4f} ms (plain "
                      f"{f[1]:.4f} ms, bound {f[2]:.4f} ms {f[3]}), backward "
                      f"{b[0]:.4f} ms (plain {b[1]:.4f} ms, bound {b[2]:.4f} "
                      f"ms {b[3]})" for K, (f, b) in rows_78.items())
          + "; validation A/B without autograd, walk kernel alone / with the "
          f"grid guard vs per-gap route (gap kernel): "
          + "; ".join(f"{r} rows {a:.4f} / {g:.4f} vs {b:.4f} ms (max abs "
                      f"diff {e:.2e})" for r, (a, g, b, e) in ab.items()),
          flush=True)
    return {"walk_fwd": rows_78[2][0], "walk_bwd": rows_78[2][1]}


# ------------------------------------------------------- scaled training

SCALED_H, SCALED_BS, SCALED_MW = 256, 4096, (1.0, 10.0)
SCALED_TRAIN, SCALED_VAL, SCALED_EPOCHS = 100_000, 5_000, 100
STEP_ACTS = (("relu", "identity"), ("tanh", "tanh"), ("elu", "sigmoid"))


def step_case(gen: torch.Generator, H: int, N: int, shared: bool, L: int,
              act: str, scale: str, rows: int, dev: torch.device,
              d: int = 1) -> dict:
    """Random fused-step inputs: a model's packed weights (torch's default
    law) for d_x = d_y = d, sorted times from 0 with the last slots of
    every fifth row repeating the one before (padding: DT = 0), log-normal
    values and an output cotangent."""
    model = NeuralJumpODE(d, H, d, num_moments=2, n_hidden_layers=L,
                          activation=act, input_scaling=scale,
                          shared_network=shared, device="cpu",
                          generator=torch.Generator().manual_seed(H + N + L))
    with torch.no_grad():
        W, V, _ = fs.pack_params(model)
    t = torch.sort(torch.rand(rows, N, generator=gen), dim=1).values
    t[:, 0] = 0.0
    if N > 2:
        t[::5, -1] = t[::5, -2]
    c = {"W": W, "V": V, "times": t,
         "values": torch.exp(torch.randn(rows, N, d, generator=gen) * 0.3),
         "gy": torch.randn(rows, 2 * N - 1, d, 2, generator=gen)}
    c = {k: v.to(dev).contiguous() for k, v in c.items()}
    c["Wb"] = c["W"].to(BF16)            # the planes as FusedStep casts them
    c["lo"] = fs.layout_of(model)
    return c


def step_fwd(c: dict, act: str, scale: str, kernel: bool, cdt=None):
    """Row 9 (cdt None) or 9b (cdt bf16), or its plain version."""
    if kernel:
        return fs._launch_fwd(c["W" if cdt is None else "Wb"], c["V"],
                              c["times"], c["values"], c["lo"], act, scale,
                              step_plan(c, cdt)[0])
    return fs.fused_step_forward_reference(c["W"], c["V"], c["times"],
                                           c["values"], c["lo"], act, scale,
                                           cdt)


def step_bwd(c: dict, act: str, scale: str, kernel: bool, cdt=None):
    """Row 10 (cdt None) or 10b (cdt bf16), or its plain version."""
    if kernel:
        return fs._launch_bwd(c["W" if cdt is None else "Wb"], c["V"],
                              c["times"], c["values"], c["gy"], c["lo"], act,
                              scale, step_plan(c, cdt)[1])
    return fs.fused_step_backward_reference(c["W"], c["V"], c["times"],
                                            c["values"], c["gy"], c["lo"],
                                            act, scale, cdt)


def step_plan(c: dict, cdt=None) -> tuple:
    """(trajectories a tile, slots a group) of the forward and backward of
    the f32 (cdt None) or bf16 instances."""
    lo = c["lo"]
    return fs.kernel_plan(c["W"].shape[-1], c["times"].shape[1], lo.L,
                          lo.d_x, lo.d_y, lo.K, cdt is not None)


# rows 9-10 (f32 fma on the CUDA cores) against their plain versions
# (cuBLAS in f32, TF32 off): the forward entrywise at RTOL / ATOL and
# within STEP_FWD_NORM of its norm, each dW plane and dV row within
# STEP_GRAD_RTOL of its norm, or GRAD_RTOL for relu, whose kinks turn the
# other way under another summation order (a pre-activation within
# rounding of zero moves one row's cotangent; the H100 readings: up to
# 8.9e-4 with relu, 1.4e-5 without).  The limits are set so that the
# control fails them: the plain version on the same input in 1xTF32
# (TF32Operands, with allow_tf32 on) must fail the forward and the
# backward check in every case.  The entrywise forward limit alone does
# not catch TF32 (a CPU emulation at the scaled shape, relu/identity,
# 1,024 rows: at 0.88 of it); normwise, 1xTF32 sits at 1.5e-4 - 1.3e-3
# forward and 5e-4 - 1.3e-1 backward (tests/test_torch_fused_step.py, and
# the H100 readings).
STEP_FWD_NORM, STEP_GRAD_RTOL = 1e-5, 1e-4
# rows 9b-10b against their plain versions: both round the same operands to
# bf16 and sum bf16-exact products in f32, in other orders; where that
# moves a downstream activation across a bf16 rounding boundary, it moves
# by one bf16 ulp (2^-8 relative) and carries on.  Forward entrywise at
# BF16_RTOL / BF16_ATOL, each dW plane and dV row within BF16_GRAD_RTOL of
# its norm (the plain version summed in float64 against float32 on the CPU,
# this phase's grid at 512 rows: at most 5.5e-4 abs forward and 1.2e-2 of a
# norm backward), and the ratio test (step_ratio_share): the kernel's
# distance from the plain bf16 run, in Y and in each dW plane and dV row,
# at most STEP_RATIO x the plain bf16 run's from the plain f32 run (the
# backward at STEP_RATIO_BWD: a relu kink or a bf16 rounding that turns the
# other way under another summation order moves single rows, and on the
# H100 the CUDA-core bf16 kernel read 0.101 at the scaled shape, the tensor
# cores up to 0.146 with L 2); the f32 instance on the same input is the
# control and must fail it (it reads 1.0).
BF16_RTOL, BF16_ATOL, BF16_GRAD_RTOL = 2e-2, 2e-3, 5e-2
STEP_RATIO, STEP_RATIO_BWD = 0.1, 0.2


def step_items(out) -> list:
    """A fused-step output as the ratio test's items: Y whole, or each dW
    plane and dV row of (dW, dV)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x[i, j] for x in out for i in range(x.shape[0])
            for j in range(x.shape[1])]


def step_ratio_share(ours, ref, ref32, ratio: float = STEP_RATIO) -> float:
    """The ratio test's share (above 1 fails): the largest over items of
    ||ours - ref|| / (ratio ||ref - ref32||) (Frobenius); ref the plain
    bf16 run, ref32 the plain f32 run.  Normwise, not by the largest entry:
    a one-ulp flip of a downstream bf16 rounding under another summation
    order moves single entries by up to 0.15 of the bf16 effect's largest
    (the plain bf16 version against itself with its hidden units permuted,
    H 32, N 10, L 2), 0.03 of its norm.  An item the bf16 mode leaves
    unchanged (a plane with no gradient) counts only if ours moves it."""
    worst = 0.0
    for a, b, c in zip(*(step_items(x) for x in (ours, ref, ref32))):
        a, b, c = (x.detach().cpu().double() for x in (a, b, c))
        if not torch.isfinite(a).all():
            return math.inf
        dist, gap = float((a - b).norm()), float((b - c).norm())
        if gap > 0:
            worst = max(worst, dist / (ratio * gap))
        elif dist > 0:
            return math.inf
    return worst


def step_fwd_share(a, b, rtol: float = RTOL, atol: float = ATOL,
                   norm: float = STEP_FWD_NORM) -> float:
    """The forward check's share of its limits (above 1 fails): entrywise
    at rtol / atol, and normwise at ``norm`` (None: entrywise only)."""
    a, b = a.cpu().double(), b.cpu().double()
    if not torch.isfinite(a).all():
        return math.inf
    share = float(((a - b).abs() / (atol + rtol * b.abs())).max())
    if norm is not None:
        share = max(share, float((a - b).norm() / b.norm().clamp_min(1e-30))
                    / norm)
    return share


def step_bwd_share(ours, ref, grad_rtol: float) -> float:
    """The backward check's share (above 1 fails): the largest ||a - b|| /
    (grad_rtol ||b||) over the dW planes and dV rows."""
    worst = 0.0
    for a, b in zip(step_items(ours), step_items(ref)):
        a, b = a.cpu().double(), b.cpu().double()
        if not torch.isfinite(a).all():
            return math.inf
        worst = max(worst, float((a - b).norm() / b.norm().clamp_min(1e-30))
                    / grad_rtol)
    return worst


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32, 10 mantissa bits, to nearest with ties
    away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class TF32Operands(TorchFunctionMode):
    """Every plane product of the plain versions (a 2-D by 2-D float32
    matmul) on operands rounded to TF32: 1xTF32 products summed in f32,
    what cuBLAS does with allow_tf32 on where it takes TF32, and also where
    it keeps f32 (an inner dimension not a multiple of 4, as at H 50)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
                and len(args) == 2 and all(
                    isinstance(a, torch.Tensor) and a.dim() == 2
                    and a.dtype == torch.float32 for a in args)):
            args = tuple(tf32_round(a) for a in args)
        return func(*args, **(kwargs or {}))


def step_plain_tf32(c: dict, act: str, scale: str) -> tuple:
    """The control of rows 9-10: their plain versions in 1xTF32 (cuBLAS
    with allow_tf32 on, restored right after, on operands rounded to
    TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TF32Operands():
            y = step_fwd(c, act, scale, False)
            g = step_bwd(c, act, scale, False)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return y, g


def step_grad_rtol(act: str, cdt=None) -> float:
    """The backward limit of rows 9-10 / 9b-10b, each dW plane and dV row
    against its norm."""
    if cdt is not None:
        return BF16_GRAD_RTOL
    return GRAD_RTOL if act == "relu" else STEP_GRAD_RTOL


def step_kernel_phase(dev: torch.device, cdt=None
                      ) -> tuple[float, float, float]:
    """Rows 9-10 (cdt None) or 9b-10b (cdt bf16) against their plain
    versions on the card: H in (32, 50, 256) x N in (1, 2, 10) x
    separate/shared x L in (1, 2), the activation pairs and row counts
    (4,096, 1,696, 5,000) taken in turn, then the scaled path's own shape
    (H 256, N 2, separate, L 1, relu/identity, 4,096 rows).  f32: forward
    at rtol 1e-4 / atol 1e-5 and STEP_FWD_NORM of its norm, every dW plane
    and dV row within step_grad_rtol of its norm, and the 1xTF32 control
    failing both.  bf16: forward at
    BF16_RTOL / BF16_ATOL, backward within BF16_GRAD_RTOL of the norm, the
    ratio test in Y, dW and dV, and the f32 instance failing the ratio
    test.  Two backward calls bitwise equal.  Returns (forward max abs err,
    backward max abs err, the largest normwise backward error)."""
    gen = torch.Generator().manual_seed(91)
    worst = {"f": 0.0, "b": 0.0, "rel": 0.0, "at": "", "fs": 0.0, "bs": 0.0,
             "rf": 0.0, "rb": 0.0, "cf": math.inf, "cb": math.inf}
    rtol, atol, norm = ((RTOL, ATOL, STEP_FWD_NORM) if cdt is None
                        else (BF16_RTOL, BF16_ATOL, None))
    rows_name = "rows 9-10" if cdt is None else "rows 9b-10b (bf16)"

    def check(H, N, shared, L, act, scale, rows) -> float:
        """One case; returns its largest normwise backward error."""
        c = step_case(gen, H, N, shared, L, act, scale, rows, dev)
        where = f"H={H} N={N} shared={shared} L={L} {act}/{scale} rows={rows}"
        grad_rtol = step_grad_rtol(act, cdt)
        with torch.no_grad():
            y_k = step_fwd(c, act, scale, True, cdt)
            y_p = step_fwd(c, act, scale, False, cdt)
            g_k = step_bwd(c, act, scale, True, cdt)
            g_k2 = step_bwd(c, act, scale, True, cdt)
            g_p = step_bwd(c, act, scale, False, cdt)
        torch.cuda.synchronize()
        worst["f"] = max(worst["f"], assert_close(
            y_k, y_p, f"{rows_name} forward at {where}", rtol, atol))
        fs_k = step_fwd_share(y_k, y_p, rtol, atol, norm)
        if not fs_k <= 1.0:
            raise AssertionError(f"{rows_name} forward at {where}: share "
                                 f"{fs_k:.3f} of the limits (rtol {rtol}, "
                                 f"atol {atol}, norm {norm})")
        worst["fs"] = max(worst["fs"], fs_k)
        worst["bs"] = max(worst["bs"], step_bwd_share(g_k, g_p, grad_rtol))
        case_rel = 0.0
        for a, a2, b, what in zip(g_k, g_k2, g_p, ("dW", "dV")):
            if not torch.equal(a, a2):
                raise AssertionError(f"two backward calls differ in {what} "
                                     f"at {where}")
            for i in range(a.shape[0]):
                for j in range(a.shape[1]):
                    worst["b"] = max(worst["b"], assert_close_norm(
                        a[i, j], b[i, j], f"{what}[{i}, {j}] at {where}",
                        grad_rtol))
                    rel = float((a[i, j] - b[i, j]).norm()
                                / b[i, j].norm().clamp_min(1e-30))
                    case_rel = max(case_rel, rel)
                    if rel > worst["rel"]:
                        worst["rel"] = rel
                        worst["at"] = f"{what}[{i}, {j}] at {where}"
        if cdt is None:                  # the 1xTF32 control must fail
            y_c, g_c = step_plain_tf32(c, act, scale)
            cf = step_fwd_share(y_c, y_p, rtol, atol, norm)
            cb = step_bwd_share(g_c, g_p, grad_rtol)
            if not (cf > 1.0 and cb > 1.0):
                raise AssertionError(
                    f"the 1xTF32 control passes the f32 checks at {where} "
                    f"(forward share {cf:.3f}, backward {cb:.3f}); they "
                    f"cannot tell f32 from 1xTF32")
            worst["cf"], worst["cb"] = min(worst["cf"], cf), min(worst["cb"],
                                                                 cb)
        else:                            # the ratio test, f32 the control
            with torch.no_grad():
                y_f = step_fwd(c, act, scale, False)
                g_f = step_bwd(c, act, scale, False)
                y_k32 = step_fwd(c, act, scale, True)
                g_k32 = step_bwd(c, act, scale, True)
            torch.cuda.synchronize()
            rf = step_ratio_share(y_k, y_p, y_f)
            rb = step_ratio_share(g_k, g_p, g_f, STEP_RATIO_BWD)
            if not (rf <= 1.0 and rb <= 1.0):
                raise AssertionError(
                    f"{rows_name} fail the ratio test at {where}: forward "
                    f"share {rf:.3f}, backward {rb:.3f}")
            cf = step_ratio_share(y_k32, y_p, y_f)
            cb = step_ratio_share(g_k32, g_p, g_f, STEP_RATIO_BWD)
            if not (cf > 1.0 and cb > 1.0):
                raise AssertionError(
                    f"the f32 instance passes the ratio test at {where} "
                    f"(forward share {cf:.3f}, backward {cb:.3f})")
            worst["rf"], worst["rb"] = max(worst["rf"], rf), max(worst["rb"],
                                                                 rb)
            worst["cf"], worst["cb"] = min(worst["cf"], cf), min(worst["cb"],
                                                                 cb)
        return case_rel

    n = 0
    for H in (32, 50, SCALED_H):
        for N in (1, 2, 10):
            for shared in (False, True):
                for L in (1, 2):
                    act, scale = STEP_ACTS[n % 3]
                    check(H, N, shared, L, act, scale,
                          (4096, 1696, 5000)[(n // 3) % 3])
                    n += 1
    main_rel = check(SCALED_H, 2, False, 1, "relu", "identity", SCALED_BS)
    n += 1
    main_lim = step_grad_rtol("relu", cdt)
    if cdt is None:
        limits = (f"rtol {rtol} / atol {atol} and {norm} of the norm; "
                  f"backward each dW plane and dV row within {STEP_GRAD_RTOL} "
                  f"of its norm ({GRAD_RTOL} with relu)")
        extra = (f"; the 1xTF32 control (the plain version on TF32 operands, "
                 f"allow_tf32 on) fails in every case, its smallest share of "
                 f"the forward limits {worst['cf']:.3f}, of the backward "
                 f"limit {worst['cb']:.3f}")
    else:
        limits = (f"rtol {rtol} / atol {atol}; backward each dW plane and dV "
                  f"row within {BF16_GRAD_RTOL} of its norm")
        extra = (f"; the ratio test (no further from the plain bf16 run than "
                 f"{STEP_RATIO} forward, {STEP_RATIO_BWD} backward x its "
                 f"distance from plain f32, normwise) worst share forward "
                 f"{worst['rf']:.3f}, backward {worst['rb']:.3f}; the f32 "
                 f"instance (the control) fails it in every case, smallest "
                 f"share forward {worst['cf']:.3f}, backward "
                 f"{worst['cb']:.3f}")
    print(f"fused-step kernels, {rows_name}, vs plain: {n} cases (H in (32, "
          f"50, 256) x N in (1, 2, 10) x separate/shared x L in (1, 2); "
          f"relu/identity, tanh/tanh, elu/sigmoid and rows 4,096, 1,696, "
          f"5,000 in turn; then the scaled path's shape, H {SCALED_H}, N 2, "
          f"separate, L 1, relu/identity, {SCALED_BS} rows), limits forward "
          f"{limits}: forward max abs err {worst['f']:.3e}, worst share "
          f"{worst['fs']:.3f}; backward max abs err {worst['b']:.3e}, largest "
          f"error/norm {worst['rel']:.3e} ({worst['at']}), worst share "
          f"{worst['bs']:.3f}; at the scaled path's shape {main_rel:.3e} = "
          f"{main_rel / main_lim:.3f} of its limit{extra}; two backward "
          f"calls bitwise equal", flush=True)
    return worst["f"], worst["b"], worst["rel"]


def bf16_exact_case(H: int = 16, seed: int = 3) -> tuple:
    """One trajectory of N 2, one hidden layer, two networks, relu/identity,
    whose every f32 operation is exact: weights and V in multiples of 1/8,
    values 1 + k/1024, times 0 and 0.5, cotangents in multiples of 1/4.
    The jump's activations then carry more bits than bf16 holds, so the
    bf16 rounding at each product changes the result (it differs from the
    float32 plain version), while every sum is exact in any order."""
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    lo = fs.layout_of(model)
    g = torch.Generator().manual_seed(seed)

    def eighths(*shape, div=8):
        return torch.randint(-4, 5, shape, generator=g).float() / div
    c = {"W": eighths(lo.Kn, lo.n_mats, H, H), "V": eighths(lo.Kn, lo.n_rows, H),
         "times": torch.tensor([[0.0, 0.5]]),
         "values": 1 + torch.randint(1, 64, (1, 2, 1), generator=g).float()
         / 1024, "gy": eighths(1, 3, 1, 2, div=4)}
    return c, lo


def bf16_bitwise_check(dev: torch.device) -> None:
    """Rows 9b-10b bitwise against their plain version on bf16_exact_case,
    after the CPU shows the case exact (the plain version in float32 equals
    it in float64) and sensitive to the rounding (it differs from the
    float32 mode)."""
    c, lo = bf16_exact_case()
    args = ("relu", "identity")
    f32 = [c[k] for k in ("W", "V", "times", "values")]
    f64 = [x.double() for x in f32]
    y32 = fs.fused_step_forward_reference(*f32, lo, *args, BF16)
    y64 = fs.fused_step_forward_reference(*f64, lo, *args, BF16)
    b32 = fs.fused_step_backward_reference(*f32, c["gy"], lo, *args, BF16)
    b64 = fs.fused_step_backward_reference(*f64, c["gy"].double(), lo, *args,
                                           BF16)
    y_f32_mode = fs.fused_step_forward_reference(*f32, lo, *args)
    if not (torch.equal(y32.double(), y64)
            and all(torch.equal(a.double(), b) for a, b in zip(b32, b64))):
        raise AssertionError("the bitwise case is not exact in float32")
    if torch.equal(y32, y_f32_mode):
        raise AssertionError("the bitwise case does not see the bf16 rounding")
    cd = {k: v.to(dev) for k, v in c.items()}
    cd["Wb"], cd["lo"] = cd["W"].to(BF16), lo
    with torch.no_grad():
        y_k = step_fwd(cd, *args, True, BF16)
        g_k = step_bwd(cd, *args, True, BF16)
    torch.cuda.synchronize()
    if not (torch.equal(y_k.cpu(), y32)
            and all(torch.equal(a.cpu(), b) for a, b in zip(g_k, b32))):
        raise AssertionError(
            f"rows 9b-10b differ from their plain version on the exact case: "
            f"forward max abs err {float((y_k.cpu() - y32).abs().max()):.3e}")
    print(f"rows 9b-10b on the exact case (H 16, N 2, one trajectory, one "
          f"hidden layer, relu/identity, every f32 operation exact): forward "
          f"and backward bitwise equal to the plain version, which differs "
          f"from the float32 mode by up to "
          f"{float((y32 - y_f32_mode).abs().max()):.3e}", flush=True)


SCALED_STEPS = -(-SCALED_TRAIN // SCALED_BS)    # 25; the last has 1,696 rows
SCALED_COMPOSED_EPOCHS = 5  # timed epochs of the composed arm


def scaled_config(n_epochs: int, name: str) -> dict:
    """scripts/run_scaled_sweep.sh's flags (100,000 / 5,000 trajectories,
    batch 4,096, hidden 256, obs fraction 0.02, two moments, --kernels step)
    and the CLI's other defaults (two separate networks, relu, identity
    scaling, moment weights [1, 10], no dt_ode_step, print every 5)."""
    return recipe_config("scaled", n_epochs, name)


def scaled_path_phase(dev: torch.device, tmp: Path) -> None:
    """run_experiment of the scaled config, 2 epochs then a resume to 3.
    The caller sets every launch count to 0 before and reads them after:
    row 10 launches once a step, row 9 once a step, once for each epoch's
    validation (5,000 rows, no autograd) and once for the relative loss
    (epoch 0 only, print every 5); no other kernel runs."""
    def counts():
        return (fs.LAUNCHES_FWD, fs.LAUNCHES_BWD)
    res = run_experiment(scaled_config(2, "scaled_bs"), save_dir=str(tmp))
    torch.cuda.synchronize()
    hist = res["history"]["train_loss"]
    want = (2 * SCALED_STEPS + 2 + 1, 2 * SCALED_STEPS)
    if counts() != want or len(hist) != 2:
        raise AssertionError(f"2 scaled epochs gave fused-step launches "
                             f"{counts()} (expected {want}) and {len(hist)} "
                             f"losses")
    if not all(math.isfinite(x) for x in hist + res["history"]["val_loss"]):
        raise AssertionError(f"non-finite scaled losses {res['history']}")
    res3 = run_experiment(scaled_config(3, "scaled_bs"), save_dir=str(tmp))
    torch.cuda.synchronize()
    hist3 = res3["history"]["train_loss"]
    want = (3 * SCALED_STEPS + 3 + 1, 3 * SCALED_STEPS)
    if counts() != want or len(hist3) != 3 or hist3[:2] != hist:
        raise AssertionError(f"the resume to 3 epochs gave fused-step "
                             f"launches {counts()} (expected {want}) and "
                             f"losses {hist3} after {hist}")
    others = (gap_scan.LAUNCHES, tk.LAUNCHES, wt.LAUNCHES,
              walk_scan.LAUNCHES_FWD, walk_scan.LAUNCHES_BWD,
              fs.LAUNCHES_FWD_BF16, fs.LAUNCHES_BWD_BF16)
    if any(others):
        raise AssertionError(f"the scaled path launched other kernels: gap, "
                             f"train_run, walk_train, walk fwd/bwd, fused "
                             f"step bf16 fwd/bwd {others}")
    print(f"scaled training path: run_experiment (hidden {SCALED_H}, two "
          f"networks, K=2, batch {SCALED_BS}, {SCALED_TRAIN:,} fresh "
          f"trajectories per epoch in {SCALED_STEPS} steps, {SCALED_VAL:,} "
          f"validation, use_pallas 'step') 2 epochs: train loss "
          f"{hist[0]:.4f} -> {hist[-1]:.4f}, val "
          f"{res['history']['val_loss'][-1]:.4f}; resumed to 3 (loss "
          f"{hist3[-1]:.4f}); launches in this window: fused-step forward "
          f"{fs.LAUNCHES_FWD}, backward {fs.LAUNCHES_BWD}; gap, train_run, "
          f"walk_train, walk forward/backward, bf16 forward/backward "
          f"{others}", flush=True)


def scaled_model(dev: torch.device, use_pallas, seed: int = 0,
                 compute_dtype=None) -> NeuralJumpODE:
    return NeuralJumpODE(1, SCALED_H, 1, num_moments=2, use_pallas=use_pallas,
                         compute_dtype=compute_dtype, device=dev,
                         generator=torch.Generator().manual_seed(seed))


def step_vs_composed_phase(dev: torch.device) -> float:
    """One epoch of identical data (100,000 fresh trajectories of the scaled
    recipe's law in 25 minibatches of 4,096, the last trajectory-masked)
    through apply_loss + autograd + Adam, on the fused-step kernels and on
    the composed path, from identical weights: per-step losses at rtol 1e-4
    / atol 1e-5, each parameter within GRAD_RTOL of its norm after the
    epoch (Adam turns a gradient entry near 0 whose sign a relu kink flips
    into a full lr step)."""
    cfg = scaled_config(1, "ab")
    train_fn, _ = create_data_loaders(base_seed=8, device=dev, **cfg["data"])
    times, values, mask, _ = as_dense(train_fn(0), dev)
    losses, params = [], []
    for up in ("step", False):
        model = scaled_model(dev, up, seed=4)
        tr = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True,
                     moment_weights=list(SCALED_MW), use_train_kernel=False)
        idx, valid = tr._minibatches(0, times.shape[0], SCALED_BS, True)
        step_losses = []
        for ids, vm in zip(idx, valid):
            tr.optimizer.zero_grad(set_to_none=True)
            loss = tr._loss(times[ids], values[ids], mask[ids], traj_mask=vm,
                            training=True)
            loss.backward()
            tr.optimizer.step()
            step_losses.append(loss.detach())
        losses.append(torch.stack(step_losses))
        params.append({k: v.detach() for k, v in model.named_parameters()})
    err = assert_close(losses[0], losses[1],
                       "fused-step vs composed per-step losses")
    p_err = max(assert_close_norm(params[0][k], params[1][k],
                                  f"fused-step vs composed {k}")
                for k in params[1])
    print(f"fused-step kernels vs composed path: one epoch ({SCALED_STEPS} "
          f"steps of {SCALED_BS}) from identical weights, per-step losses "
          f"max abs err {err:.3e}, parameters max abs err {p_err:.3e} "
          f"(each within {GRAD_RTOL} of its norm)", flush=True)
    return err


def step_flops(H: int, N: int, lo, rows: int) -> float:
    """The forward's products per call (bench.py:468-481's count at the
    logical shapes, for L hidden layers): per network and row, N jumps,
    2N - 1 readouts and N - 1 ODE steps."""
    nets = 1 if lo.shared else lo.K
    out_cols = lo.K * lo.d_y if lo.shared else lo.d_y
    L = lo.L
    per = (N * (lo.d_x * H + L * H * H)
           + (2 * N - 1) * (L * H * H + H * out_cols)
           + (N - 1) * ((H + lo.d_x + 2) * H + L * H * H))
    return 2.0 * nets * per * rows


def scaled_times_phase(dev: torch.device, card: str) -> dict:
    """Host clock around synchronized Trainer.train calls; CUDA events for
    rows 9-10.  Returns each kernel's (ms, plain ms, bound ms, bound_by)."""
    E = SCALED_EPOCHS
    cfg = scaled_config(E, "timed")
    train_fn, val_fn = create_data_loaders(base_seed=1, device=dev,
                                           **cfg["data"])

    def trainer(up) -> Trainer:
        m = scaled_model(dev, up)
        return Trainer(m, make_adam(m.parameters(), 1e-3, 5e-4),
                       ignore_first_continuity=True,
                       moment_weights=list(SCALED_MW), use_train_kernel=False)

    def epochs(tr, n):
        return timed_epochs(tr, train_fn, val_fn, cfg, n, SCALED_BS)
    step_tr = trainer("step")
    fs.LAUNCHES_FWD = fs.LAUNCHES_BWD = 0
    step_s = epochs(step_tr, E)
    print(f"scaled recipe ({E} epochs): launches of the fused-step forward "
          f"(row 9) {fs.LAUNCHES_FWD}, backward (row 10) {fs.LAUNCHES_BWD}",
          flush=True)
    mse_mean, mse_var, rel = val_metrics(step_tr.model, dev, SCALED_MW,
                                         n=SCALED_VAL, obs_fraction=0.02)
    comp_tr = trainer(False)
    epochs(comp_tr, 1)
    n_c = SCALED_COMPOSED_EPOCHS
    comp_s = epochs(comp_tr, n_c) * E / n_c
    # the A/B behind the "auto" gate (AUTO_SHAPE_H100, AUTO_MIN_BATCH_H100),
    # whose shape is this recipe's: one epoch each, in turns
    if not scaled_model(dev, "auto")._use_fused_step(2, SCALED_BS):
        raise AssertionError("'auto' does not take the fused step at the "
                             "scaled recipe's shape")
    ab = {"step": [], "composed": []}
    for arm in ("step", "composed", "composed", "step"):
        ab[arm].append(epochs(step_tr if arm == "step" else comp_tr, 1))

    # rows 9-10 at their main-path shapes, and row 9 at validation's
    gen = torch.Generator().manual_seed(17)
    c = step_case(gen, SCALED_H, 2, False, 1, "relu", "identity", SCALED_BS,
                  dev)
    c_val = step_case(gen, SCALED_H, 2, False, 1, "relu", "identity",
                      SCALED_VAL, dev)
    with torch.no_grad():
        run = {(k, b): (lambda k=k, b=b: (step_bwd if b else step_fwd)(
            c, "relu", "identity", k)) for k in (True, False)
            for b in (False, True)}
        t = {key: [] for key in run}
        for key in ((True, False), (False, False), (True, True),
                    (False, True)) * 2:
            t[key].append(time_ms(run[key], warmup=3, reps=20))
        f_val = time_ms(lambda: step_fwd(c_val, "relu", "identity", True))
    med = {key: statistics.median(v) for key, v in t.items()}
    lo = c["lo"]
    flops = step_flops(SCALED_H, 2, lo, SCALED_BS)
    io = 4 * (c["W"].numel() + c["V"].numel() + c["times"].numel()
              + c["values"].numel())
    # bound: f32-accurate products at their fastest on this card, 3xTF32 (3
    # TF32 products each) on the tensor cores; the CUDA cores' f32 bound
    # printed beside
    b_io = io + 4 * (c["gy"].numel() + c["W"].numel() + c["V"].numel())
    f_bound = bound_of(3 * flops, io + 4 * c["gy"].numel(), PEAK_TF32_FLOPS)
    # the backward rematerializes the forward: three forwards' products
    b_bound = bound_of(9 * flops, b_io, PEAK_TF32_FLOPS)
    f_cc, b_cc = (bound_of(flops, io + 4 * c["gy"].numel())[0],
                  bound_of(3 * flops, b_io)[0])
    # the bytes of the backward's scratch (the records, the dW chunk
    # partials, the tiles' dV partials), written and read once
    scratch_b = 2 * 4 * fs._load_kernel().njode_step_scratch_floats(
        SCALED_BS, 2, SCALED_H, lo.L, lo.d_x, lo.d_y, lo.K, int(lo.shared),
        step_plan(c)[1][0], 0)
    n = E * SCALED_TRAIN
    print(f"scaled times on {card}: the recipe ({E} epochs x "
          f"{SCALED_TRAIN:,} fresh trajectories, batch {SCALED_BS}, hidden "
          f"{SCALED_H}, validation {SCALED_VAL:,}) through Trainer.train on "
          f"the fused-step kernels {step_s:.3f} s = {n / step_s:.0f} traj/s "
          f"(final train loss {step_tr.train_losses[E - 1]:.4f}); composed "
          f"path ({n_c} epochs after one, scaled to {E}) {comp_s:.3f} s = "
          f"{n / comp_s:.0f} traj/s; the A/B of the 'auto' gate, one epoch "
          f"each in turns "
          f"(step, composed, composed, step): step "
          f"{', '.join(f'{x:.4f}' for x in ab['step'])} s, composed "
          f"{', '.join(f'{x:.4f}' for x in ab['composed'])} s; val MSE after "
          f"{E} epochs ({SCALED_VAL:,} trajectories): mean {mse_mean:.3e} "
          f"var {mse_var:.3e}, relative loss {rel:.4f}", flush=True)
    print(f"fused-step kernels on {card}, two networks, H {SCALED_H}, N 2, "
          f"{SCALED_BS} rows: forward "
          f"{', '.join(f'{x:.4f}' for x in t[True, False])} ms (plain "
          f"{', '.join(f'{x:.4f}' for x in t[False, False])} ms; bound "
          f"{f_bound[0]:.4f} ms {f_bound[1]} at 3xTF32, {f_cc:.4f} ms at the "
          f"CUDA cores' f32 peak); backward "
          f"{', '.join(f'{x:.4f}' for x in t[True, True])} ms (plain "
          f"{', '.join(f'{x:.4f}' for x in t[False, True])} ms; bound "
          f"{b_bound[0]:.4f} ms {b_bound[1]} at 3xTF32, {b_cc:.4f} ms at the "
          f"CUDA cores' f32 peak; the records and partials "
          f"{scratch_b / 1e6:.1f} MB written and read, "
          f"{1e3 * scratch_b / PEAK_BYTES:.4f} ms at 3.35 TB/s); forward at "
          f"{SCALED_VAL:,} validation rows {f_val:.4f} ms; launch plan "
          f"(trajectories a tile, slots a group) {step_plan(c)}", flush=True)
    return {"fused_step_fwd": (med[True, False], med[False, False], *f_bound),
            "fused_step_bwd": (med[True, True], med[False, True], *b_bound)}


# ------------------------------------------- forced training (use_pallas=True)

GAP_TRAIN_SOURCE = "njode_tpu_torch/ops/csrc/gap_train.cu"
CELL_SOURCE = "njode_tpu_torch/ops/csrc/fused_cell.cu"
GAP_TRAIN_ACTS = (("relu", "identity"), ("tanh", "tanh"), ("selu", "sigmoid"))
STRIDES_AB = (1, 4, 8, 16)   # residual strides of the A/B at n_sub 100


def gap_train_case(gen: torch.Generator, K: int, R: int, d_h: int,
                   n_sub: int, dev: torch.device) -> dict:
    """gap_case's gaps (zero, partial, on the grid, free up to the budget),
    raw ODEFunc weights in torch's orientation, and a cotangent of h_L."""
    c = gap_case(gen, K, R, d_h, 1, n_sub, dev)
    c["raw"] = cell_weights(gen, K, d_h, dev)
    c["weights"] = gap_scan.split_weights(c["raw"])
    c["ct"] = torch.randn(K, R, d_h, generator=gen).to(dev)
    return c


def gap_autograd(c: dict, n_sub: int, act: str, scale: str, fn) -> list:
    """h(t_target) of integrate_gap_fused (the training pair through
    GapScan on the card) or integrate_gap_reference (plain autograd), and
    the cotangents of h, x and the four raw weights."""
    h = c["h"].detach().requires_grad_()
    x = c["x_scaled"].detach().requires_grad_()
    raw = [w.detach().requires_grad_() for w in c["raw"]]
    out, _ = fn(h, x, c["t_last"], c["t_target"], gap_scan.split_weights(raw),
                DT, n_sub, act, scale)
    return [out.detach()] + list(torch.autograd.grad(out, [h, x, *raw],
                                                     c["ct"]))


GAP_OUTPUTS = ("gh0", "gpre_sum", "acc_t", "gdh_sum", "dW1h", "dW2")


def gap_pair_check(args: tuple, ct: torch.Tensor, dt: float, n_sub: int,
                   act: str, scale: str, where: str) -> tuple:
    """Rows 2-5 (the residual stride of n_sub) against their plain versions
    on one input: h_L and the stored states at rtol 1e-4 / atol 1e-5, t_L
    and the stored t bitwise; each backward output (gh0, the three row
    sums, dW1h, dW2), from the cotangent ct, within GRAD_RTOL of its norm
    against the reverse loop's plain version and within RECORDS_RTOL of it
    against the plain pair of the kernel's own data flow
    (gap_bwd_records_reference on the kernel's residuals: counts by the
    float sequence, the longest-first order, records by segment, chunked
    sums in the kernel's order), and two backward calls bitwise equal; the
    counts' t sequence bitwise the forward's t_L.  Returns the forward's
    and the backward's max abs err, the backward's largest error/norm
    against the reverse loop and against the records' plain pair."""
    tail = (dt, n_sub, gap_scan.residual_stride(n_sub), act, scale)
    bargs = (ct, args[1], args[3], *args[4:])
    with torch.no_grad():
        fk = gap_scan._launch_train_fwd(*args, *tail)
        fp = gap_scan.gap_train_forward_reference(*args, *tail)
        bk = gap_scan._launch_train_bwd(*bargs, fk[2], fk[3], *tail)
        bk2 = gap_scan._launch_train_bwd(*bargs, fk[2], fk[3], *tail)
        bp = gap_scan.gap_train_backward_reference(*bargs, fp[2], fp[3],
                                                   *tail)
        bq = gap_scan.gap_bwd_records_reference(*bargs, fk[2], fk[3], *tail)
        _, t_count = gap_scan.gap_substep_counts(args[2], args[3], dt, n_sub)
    torch.cuda.synchronize()
    for a, b, what in ((fk[1], fp[1], "t_L"), (fk[3], fp[3], "stored t"),
                       (t_count, fk[1], "the counts' t sequence")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} not bitwise equal at {where}")
    f_err = max(assert_close(a, b, f"gap training forward {what} at {where}")
                for a, b, what in ((fk[0], fp[0], "h_L"),
                                   (fk[2], fp[2], "stored h")))
    b_err = rel = 0.0
    for a, a2, b, what in zip(bk, bk2, bp, GAP_OUTPUTS):
        if not torch.equal(a, a2):
            raise AssertionError(f"two backward calls differ in {what} at "
                                 f"{where}")
        b_err = max(b_err, assert_close_norm(
            a, b, f"gap backward {what} at {where}"))
        rel = max(rel, float((a - b).double().norm()
                             / b.double().norm().clamp_min(1e-30)))
    rec_rel = 0.0
    for a, b, what in zip(bk, bq, GAP_OUTPUTS):
        b_err = max(b_err, assert_close_norm(
            a, b, f"gap backward {what} vs the records' plain pair at "
            f"{where}", rtol=RECORDS_RTOL))
        rec_rel = max(rec_rel, float((a - b).double().norm()
                                     / b.double().norm().clamp_min(1e-30)))
    return f_err, b_err, rel, rec_rel


def gap_stride_bitwise_check(args: tuple, ct: torch.Tensor, dt: float,
                             n_sub: int, act: str, scale: str,
                             where: str) -> None:
    """The pair at stride 1 (rows 2 and 4) and at stride CK (rows 3 and 5)
    on one input: h_L, t_L, the checkpoints at the shared positions
    (res_h[CK m] and res_t[CK m] at stride 1 against res_h[m], res_t[m] at
    stride CK) and every backward output bitwise equal.  The forward and the
    backward's rebuild take each substep from one function, so the states
    the backward differentiates at stride CK are the ones the forward
    stored at stride 1."""
    ck = gap_scan.CK
    bargs = (ct, args[1], args[3], *args[4:])
    with torch.no_grad():
        f1 = gap_scan._launch_train_fwd(*args, dt, n_sub, 1, act, scale)
        fc = gap_scan._launch_train_fwd(*args, dt, n_sub, ck, act, scale)
        b1 = gap_scan._launch_train_bwd(*bargs, f1[2], f1[3], dt, n_sub, 1,
                                        act, scale)
        bc = gap_scan._launch_train_bwd(*bargs, fc[2], fc[3], dt, n_sub, ck,
                                        act, scale)
    torch.cuda.synchronize()
    pairs = [(f1[0], fc[0], "h_L"), (f1[1], fc[1], "t_L"),
             (f1[2][::ck], fc[2], "checkpointed h"),
             (f1[3][::ck], fc[3], "checkpointed t")]
    pairs += [(a, b, f"backward {w}") for a, b, w in zip(b1, bc, GAP_OUTPUTS)]
    for a, b, what in pairs:
        if not torch.equal(a, b):
            raise AssertionError(
                f"stride 1 and stride {ck} differ in {what} at {where}: "
                f"{int((a != b).sum())} entries, max abs "
                f"{float((a - b).abs().max()):.3e}")


def gap_schedule_check(args: tuple, dt: float, n_sub: int, act: str,
                       scale: str, where: str) -> tuple[int, int]:
    """The forward (rows 2-3) on the rows in a permuted order, on the rows
    that walked one a warp alone (the long threshold falls, so some of them
    walk on groups), and with one row of n_sub substeps added
    (the threshold rises where no row took n_sub, so rows that walked on
    groups walk one a warp): each row's h_L, t_L and stored states bitwise
    equal to the whole call's.  Returns (calls compared, rows whose walker
    changed); fails if no row changed its walker."""
    stride = gap_scan.residual_stride(n_sub)
    h, base, t_last, t_target = args[:4]
    K, R, d = h.shape
    tail = (dt, n_sub, stride, act, scale)
    counts, _ = gap_scan.gap_substep_counts(t_last, t_target, dt, n_sub)

    def long_set(c):
        order, n_long = gap_scan.gap_fwd_order(c.cpu(), n_sub, stride)
        out = torch.zeros(c.shape[0], dtype=torch.bool)
        out[order[:n_long]] = True
        return out
    is_long = long_set(counts)
    perm = torch.randperm(R, generator=torch.Generator().manual_seed(R)).to(
        h.device)
    calls = [("permuted rows", perm, None)]
    rest = torch.nonzero(~is_long).flatten().to(h.device)
    if len(rest):
        calls.append(("the rows that walked one a warp", rest, None))
    calls.append((f"one row of {n_sub} substeps added",
                  torch.arange(R, device=h.device), 0))
    with torch.no_grad():
        ref = gap_scan._launch_train_fwd(*args, *tail)
        moved = 0
        for what, rows, extra in calls:
            sub = [h[:, rows], base[:, rows], t_last[rows], t_target[rows]]
            if extra is not None:
                sub = [torch.cat([h[:, rows], h[:, extra:extra + 1]], 1),
                       torch.cat([base[:, rows], base[:, extra:extra + 1]], 1),
                       torch.cat([t_last[rows], t_last[extra:extra + 1]]),
                       torch.cat([t_target[rows], t_last[extra:extra + 1]
                                  + 2 * n_sub * dt])]
            sub = [x.contiguous() for x in sub]
            c_sub, _ = gap_scan.gap_substep_counts(sub[2], sub[3], dt, n_sub)
            moved += int((long_set(c_sub)[:len(rows)]
                          != is_long[rows.cpu()]).sum())
            out = gap_scan._launch_train_fwd(*sub, *args[4:], *tail)
            n = len(rows)
            got = (out[0][:, :n], out[1][:n], out[2][:, :, :n],
                   out[3][:, :n])
            want = (ref[0][:, rows], ref[1][rows], ref[2][:, :, rows],
                    ref[3][:, rows])
            for a, b, name in zip(got, want, ("h_L", "t_L", "stored h",
                                               "stored t")):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"the forward on {what} differs in {name} at "
                        f"{where}: {int((a != b).sum())} entries")
    torch.cuda.synchronize()
    if moved == 0:
        raise AssertionError(f"no row changed its walker in the forward's "
                             f"schedule check at {where}")
    return len(calls), moved


def row5_cases(gen: torch.Generator, dev: torch.device) -> list:
    """Row 5's scheduling cases (stride 8), gap_train_case's inputs with set
    substep counts (gaps of count + 1/2 steps), as (where, case, n_sub): at
    n_sub 100 a long gap amid short ones (one row of 100 substeps among rows
    of 0-8, so one row walks on a group of warps and every other one a
    warp); counts straddling the long threshold (the longest 60, so rows of
    at least 30 are long; most rows at 29, 30 and 31, every seventh short),
    K_h 2; 18,000 rows at d_h 128 and K_h 2, gap_train_case's gaps (the step
    buffer's largest case: 2 x 8 x 2 x 18,000 x 4 x 128 floats); and at
    n_sub 1,100, past the sort's 1,024 keys, where rows are keyed by their
    segment count (gap_bwd_plan's key_seg): one gap of 1,100 substeps amid
    short ones, rows of 541-556 (segment keys 68-70 about the long
    threshold of 69, several counts to a key), and rows of 100-300, K_h 2."""
    out = []
    c = gap_train_case(gen, 1, 2304, PROD_H, N_SUB, dev)
    steps = torch.randint(0, 9, (2304,), generator=gen).float()
    steps[1234] = N_SUB
    c["t_target"] = c["t_last"] + ((steps + 0.5) * DT).to(dev)
    out.append(("a long gap amid short ones (2,304 rows, d_h 50)", c, N_SUB))
    c = gap_train_case(gen, 2, 1001, PROD_H, N_SUB, dev)
    steps = torch.tensor([29.0, 30.0, 31.0])[
        torch.randint(0, 3, (1001,), generator=gen)]
    steps[::7] = torch.randint(0, 9, (143,), generator=gen).float()
    steps[500] = 60
    c["t_target"] = c["t_last"] + ((steps + 0.5) * DT).to(dev)
    out.append(("counts straddling the long threshold (1,001 rows, d_h 50, "
                "K_h 2)", c, N_SUB))
    out.append(("18,000 rows at d_h 128, K_h 2",
                gap_train_case(gen, 2, 18000, 128, N_SUB, dev), N_SUB))
    n_long = 1100
    c = gap_train_case(gen, 2, 300, PROD_H, n_long, dev)
    steps = torch.randint(0, 9, (300,), generator=gen).float()
    steps[10:42] = torch.arange(541, 557).repeat(2).float()
    steps[100:120] = torch.randint(100, 301, (20,), generator=gen).float()
    steps[257] = n_long
    c["t_target"] = c["t_last"] + ((steps + 0.5) * DT).to(dev)
    out.append(("n_sub 1,100: rows keyed by segment count (300 rows, d_h 50, "
                "K_h 2)", c, n_long))
    return out


def gap_train_kernel_phase(dev: torch.device) -> dict:
    """Rows 2-5 against their plain versions on the card: n_sub in (1, 10,
    16, 17, 100) (the residual stride switches past 16) x d_h in (12, 50,
    128) x K_h in (1, 2), the activation/scaling pairs and rows (16, 2,304,
    18,000, and 1,001 for ragged last tiles) taken in turn; zero and partial
    gaps in every case.  Forward: h_L and the stored states at rtol 1e-4 /
    atol 1e-5, t_L and the stored t bitwise.  Backward: each kernel output
    (gh0, the three row sums, dW1h, dW2) and, through autograd, the
    cotangents of h, x and the four weights each within GRAD_RTOL of its
    norm; two backward calls bitwise equal.  Returns the (forward,
    backward) max abs err of each residual mode."""
    gen = torch.Generator().manual_seed(71)
    worst = {"full": [0.0, 0.0], "checkpointed": [0.0, 0.0]}
    worst_rel = worst_rec = 0.0
    n = 0
    for n_sub in (1, 10, 16, 17, N_SUB):
        for d_h in (12, 50, 128):
            for K in (1, 2):
                act, scale = GAP_TRAIN_ACTS[n % 3]
                R = (16, 2304, 18000, 1001)[(n // 3) % 4]
                c = gap_train_case(gen, K, R, d_h, n_sub, dev)
                where = (f"n_sub={n_sub} d_h={d_h} K={K} R={R} "
                         f"{act}/{scale}")
                args = substep_args(c, n_sub, act, scale)[:8]
                stride = gap_scan.residual_stride(n_sub)
                w_mode = worst["full" if stride == 1 else "checkpointed"]
                f_err, b_err, rel, rec = gap_pair_check(
                    args, c["ct"], DT, n_sub, act, scale, where)
                w_mode[0] = max(w_mode[0], f_err)
                w_mode[1] = max(w_mode[1], b_err)
                worst_rel = max(worst_rel, rel)
                worst_rec = max(worst_rec, rec)
                ours = gap_autograd(c, n_sub, act, scale,
                                    gap_scan.integrate_gap_fused)
                ref = gap_autograd(c, n_sub, act, scale,
                                   gap_scan.integrate_gap_reference)
                w_mode[0] = max(w_mode[0], assert_close(
                    ours[0], ref[0], f"h(t_target) under autograd at {where}"))
                for a, b, what in zip(ours[1:], ref[1:],
                                      ("h", "x", "W1", "b1", "W2", "b2")):
                    w_mode[1] = max(w_mode[1], assert_close_norm(
                        a, b, f"autograd d{what} at {where}"))
                    worst_rel = max(worst_rel, float(
                        (a - b).norm() / b.norm().clamp_min(1e-30)))
                n += 1
    # row 5's scheduling: the long tier, its threshold, the largest buffer;
    # on the first, rows 2-5's walker and stride independence
    n_same = moved = 0
    for i, (where, c, n_sub) in enumerate(row5_cases(gen, dev)):
        args = substep_args(c, n_sub, "relu", "identity")[:8]
        f_err, b_err, rel, rec = gap_pair_check(args, c["ct"], DT, n_sub,
                                                "relu", "identity", where)
        if i == 0:
            gap_stride_bitwise_check(args, c["ct"], DT, n_sub, "relu",
                                     "identity", where)
            n_same, moved = gap_schedule_check(args, DT, n_sub, "relu",
                                               "identity", where)
        worst["checkpointed"][0] = max(worst["checkpointed"][0], f_err)
        worst["checkpointed"][1] = max(worst["checkpointed"][1], b_err)
        worst_rel = max(worst_rel, rel)
        worst_rec = max(worst_rec, rec)
        n += 1
    print(f"gap training kernels vs plain: {n} cases (n_sub in (1, 10, 16, "
          f"17, 100) x d_h in (12, 50, 128) x K_h in (1, 2); relu/identity, "
          f"tanh/tanh, selu/sigmoid and rows 16, 2,304, 18,000, 1,001 in "
          f"turn; then at n_sub 100 a long gap amid short ones, counts "
          f"straddling the long threshold, 18,000 rows at d_h 128 and K_h "
          f"2, and at n_sub 1,100 rows keyed by segment count; each "
          f"backward also against the records' plain pair): max "
          f"abs err, forward / backward, full residuals "
          f"{worst['full'][0]:.3e} / {worst['full'][1]:.3e}, checkpointed "
          f"{worst['checkpointed'][0]:.3e} / {worst['checkpointed'][1]:.3e} "
          f"(forward at rtol {RTOL} / atol {ATOL}, t_L and stored t bitwise; "
          f"backward: kernel outputs and autograd cotangents, largest "
          f"error/norm {worst_rel:.3e}, limit {GRAD_RTOL}; kernel outputs "
          f"against the records' plain pair, largest error/norm "
          f"{worst_rec:.3e}, limit {RECORDS_RTOL}); two backward calls "
          f"bitwise equal; on the long gap amid short ones, the pair at "
          f"stride 1 and at stride {gap_scan.CK} bitwise equal (h_L, t_L, "
          f"shared checkpoints, every backward output) and the forward on "
          f"permuted rows and on subsets that move {moved} rows to another "
          f"walker ({n_same} calls) bitwise equal row by row", flush=True)
    return worst


def cell_weights(gen: torch.Generator, K: int, d_h: int,
                 dev: torch.device) -> list:
    """ODEFunc weights (W1, b1, W2, b2) in torch's orientation, stacked on
    K, from torch's default law (one input dimension)."""
    def uni(shape, fan_in):
        return ((torch.rand(shape, generator=gen) * 2 - 1)
                / fan_in ** 0.5).to(dev)
    d_in = d_h + 3
    return [uni((K, d_h, d_in), d_in), uni((K, d_h), d_in),
            uni((K, d_h, d_h), d_h), uni((K, d_h), d_h)]


def cell_case(gen: torch.Generator, K: int, R: int, d_h: int,
              dev: torch.device) -> dict:
    """Fused-cell inputs: states, x, substep times (dt per row, some 0),
    ODEFunc weights and a cotangent."""
    t_cur = torch.rand(R, generator=gen)
    t_new = t_cur + torch.rand(R, generator=gen) * 0.1
    t_new[::7] = t_cur[::7]
    return {"h": (torch.randn(K, R, d_h, generator=gen) * 0.5).to(dev),
            "x": torch.randn(R, 1, generator=gen).to(dev),
            "t_cur": t_cur.to(dev), "t_new": t_new.to(dev),
            "w": cell_weights(gen, K, d_h, dev),
            "ct": torch.randn(K, R, d_h, generator=gen).to(dev)}


def cell_run(c: dict, act: str, scale: str, fn) -> list:
    sc = {"identity": lambda v: v, "tanh": torch.tanh,
          "sigmoid": torch.sigmoid}[scale]
    h = c["h"].detach().requires_grad_()
    x = c["x"].detach().requires_grad_()
    w = [x_.detach().contiguous().requires_grad_() for x_ in c["w"]]
    out = fn(h, sc(x), sc(h), c["t_cur"], c["t_new"], w, act)
    return [out.detach()] + list(torch.autograd.grad(out, [h, x, *w],
                                                     c["ct"]))


CELL_SHAPES = ((2, 1152, 32), (1, 2304, 50), (2, 200, 32), (2, 37, 300),
               (1, 37, 512), (1, 9, 1800))


def fused_cell_kernel_phase(dev: torch.device) -> float:
    """Row 6 against its plain version on the card at the forced default
    path's shape (K_h 2, 1,152 rows, d_h 32), its validation's (200 rows),
    the production width (K_h 1, 2,304 rows, d_h 50), a ragged wide one
    (37 rows, d_h 300: several column chunks), and d_h 512 and 1,800, where
    fewer than 8 warps' rows fit a block's shared memory (1,800: one warp,
    near the widest that the block-staged kernel before it took): out and
    pre at rtol 1e-4 / atol 1e-5, and the Function's gradients against
    plain autograd each within GRAD_RTOL of their norm, for three
    activation/scaling pairs."""
    gen = torch.Generator().manual_seed(81)
    worst = 0.0
    n = 0
    for K, R, d_h in CELL_SHAPES:
        for act, scale in GAP_TRAIN_ACTS:
            c = cell_case(gen, K, R, d_h, dev)
            where = f"K={K} R={R} d_h={d_h} {act}/{scale}"
            inp, dt, w1, b1, w2, b2 = fused_cell._cell_inputs(
                c["h"], c["x"], c["h"], c["t_cur"], c["t_new"], c["w"])
            args = [x.contiguous() for x in (inp, c["h"], dt, w1, b1, w2, b2)]
            with torch.no_grad():
                out_k, pre_k = fused_cell._launch(*args, act)
                out_p, pre_p = fused_cell.fused_cell_reference(*args, act)
            torch.cuda.synchronize()
            worst = max(worst, assert_close(out_k, out_p, f"cell out at "
                                            f"{where}"),
                        assert_close(pre_k, pre_p, f"cell pre at {where}"))
            ours = cell_run(c, act, scale, fused_cell.ode_euler_fused)
            ref = cell_run(c, act, scale, fused_cell.ode_euler_reference)
            worst = max(worst, assert_close(ours[0], ref[0],
                                            f"cell step at {where}"))
            for a, b, what in zip(ours[1:], ref[1:],
                                  ("h", "x", "W1", "b1", "W2", "b2")):
                assert_close_norm(a, b, f"cell d{what} at {where}")
            n += 1
    print(f"fused cell kernel vs plain: {n} cases (K_h, rows, d_h) in "
          f"{CELL_SHAPES} x relu/identity, tanh/tanh, selu/sigmoid: out and "
          f"pre max abs err {worst:.3e} (rtol {RTOL} / atol {ATOL}); "
          f"gradients of the Function within {GRAD_RTOL} of their norm",
          flush=True)
    return worst


# ------------------------------ bf16 scaled training (rows 9b and 10b)

BF16_TIMED_EPOCHS = 10       # timed epochs of each arm in each turn
BF16_SEEDS = (0, 1)          # val MSE of bf16 and f32 recipes at each


def scaled_bf16_config(n_epochs: int, name: str) -> dict:
    """scaled_config with scripts/run_scaled_sweep.sh --compute-dtype
    bfloat16 (build_config's "compute_dtype")."""
    return recipe_config("scaled", n_epochs, name, "--compute-dtype",
                         "bfloat16")


def scaled_bf16_path_phase(dev: torch.device, tmp: Path) -> dict:
    """run_experiment of the bf16 scaled config, 2 epochs then a resume to
    3, in one window the caller opens: row 10b once a step; row 9b once a
    step, once for each epoch's validation and once for the relative loss
    (epoch 0); rows 9-10 in f32 and every other kernel not at all."""
    res = run_experiment(scaled_bf16_config(2, "scaled_bf16"),
                         save_dir=str(tmp))
    torch.cuda.synchronize()
    hist = res["history"]["train_loss"]
    expect_counts("the bf16 scaled path, 2 epochs",
                  {"9b": 2 * SCALED_STEPS + 2 + 1, "10b": 2 * SCALED_STEPS})
    if len(hist) != 2 or not all(math.isfinite(x) for x in
                                 hist + res["history"]["val_loss"]):
        raise AssertionError(f"bf16 scaled losses {res['history']}")
    res3 = run_experiment(scaled_bf16_config(3, "scaled_bf16"),
                          save_dir=str(tmp))
    torch.cuda.synchronize()
    hist3 = res3["history"]["train_loss"]
    got = expect_counts("the bf16 scaled path resumed to 3 epochs",
                        {"9b": 3 * SCALED_STEPS + 3 + 1,
                         "10b": 3 * SCALED_STEPS})
    if len(hist3) != 3 or hist3[:2] != hist:
        raise AssertionError(f"the resume gave losses {hist3} after {hist}")
    print(f"bf16 scaled training path: run_experiment (the scaled config "
          f"with compute_dtype bfloat16, use_pallas 'step') 2 epochs: train "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}, val "
          f"{res['history']['val_loss'][-1]:.4f}; resumed to 3 (loss "
          f"{hist3[-1]:.4f}); launches in this window by row {got}",
          flush=True)
    return got


class PlainFusedStep(torch.autograd.Function):
    """fs.FusedStep with the plain versions on the card's tensors: the
    kernels' yardstick over an epoch."""

    @staticmethod
    def forward(ctx, W, V, times, values, lo, act, scale, cdt=None):
        ctx.save_for_backward(W, V, times, values)
        ctx.meta = (lo, act, scale, cdt)
        return fs.fused_step_forward_reference(W, V, times, values, lo, act,
                                               scale, cdt)

    @staticmethod
    def backward(ctx, gy):
        W, V, times, values = ctx.saved_tensors
        dW, dV = fs.fused_step_backward_reference(W, V, times, values, gy,
                                                  *ctx.meta)
        return dW, dV, None, None, None, None, None, None


def bf16_vs_plain_epoch_phase(dev: torch.device) -> float:
    """One epoch of identical data (the scaled recipe's law, 25 minibatches
    of 4,096, the last trajectory-masked) through apply_loss + autograd +
    Adam of a bf16 "step" model, on rows 9b-10b and on their plain versions
    (PlainFusedStep in FusedStep's place), from identical weights:
    per-step losses at BF16_RTOL / BF16_ATOL, each parameter within
    BF16_GRAD_RTOL of its norm after the epoch.  Returns the losses' max
    abs err."""
    cfg = scaled_bf16_config(1, "ab")
    train_fn, _ = create_data_loaders(base_seed=8, device=dev, **cfg["data"])
    times, values, mask, _ = as_dense(train_fn(0), dev)
    losses, params = [], []
    for plain in (False, True):
        model = scaled_model(dev, "step", seed=4, compute_dtype=BF16)
        tr = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True,
                     moment_weights=list(SCALED_MW), use_train_kernel=False)
        idx, valid = tr._minibatches(0, times.shape[0], SCALED_BS, True)
        kernel_step, step_losses = fs.FusedStep, []
        fs.FusedStep = PlainFusedStep if plain else kernel_step
        try:
            for ids, vm in zip(idx, valid):
                tr.optimizer.zero_grad(set_to_none=True)
                loss = tr._loss(times[ids], values[ids], mask[ids],
                                traj_mask=vm, training=True)
                loss.backward()
                tr.optimizer.step()
                step_losses.append(loss.detach())
        finally:
            fs.FusedStep = kernel_step
        losses.append(torch.stack(step_losses))
        params.append({k: v.detach() for k, v in model.named_parameters()})
    err = assert_close(losses[0], losses[1],
                       "rows 9b-10b vs plain per-step losses", BF16_RTOL,
                       BF16_ATOL)
    p_err = max(assert_close_norm(params[0][k], params[1][k],
                                  f"rows 9b-10b vs plain {k}", BF16_GRAD_RTOL)
                for k in params[1])
    print(f"rows 9b-10b vs their plain versions: one bf16 epoch "
          f"({SCALED_STEPS} steps of {SCALED_BS}) from identical weights, "
          f"per-step losses max abs err {err:.3e} (rtol {BF16_RTOL} / atol "
          f"{BF16_ATOL}), parameters max abs err {p_err:.3e} (each within "
          f"{BF16_GRAD_RTOL} of its norm)", flush=True)
    return err


def profiled_epochs(trainer: Trainer, loaders: tuple, cfg: dict,
                    n: int) -> tuple:
    """torch.profiler over n epochs of Trainer.train after the caller's
    warm-up: (host wall ms an epoch, device ms an epoch, the device's idle
    share, device launches an epoch: kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_epochs(trainer, *loaders, cfg, n, SCALED_BS)
    cuda = torch.autograd.DeviceType.CUDA
    on_dev = [e for e in prof.events() if e.device_type == cuda]
    dev_s = sum(e.time_range.elapsed_us() for e in on_dev) / 1e6
    return 1e3 * wall / n, 1e3 * dev_s / n, 1.0 - dev_s / wall, len(on_dev) / n


def bf16_times_phase(dev: torch.device, card: str) -> dict:
    """Host clock around synchronized Trainer.train calls, CUDA events for
    rows 9b-10b.  The bf16 recipe on rows 9b-10b (its launches by row over
    the run); then, each warmed by one epoch, BF16_TIMED_EPOCHS epochs of
    the bf16 kernels, the f32 kernels and the composed bf16 path in turns
    (the A/B behind "auto"'s compute dtypes), then 2 epochs of each under
    torch.profiler (device time, idle share, launches); rows 9b-10b per
    call against their plain versions and bounds; val MSE of bf16 and f32
    recipes at BF16_SEEDS.  Returns each kernel's (ms, plain ms, bound ms,
    bound_by)."""
    E, n_t = SCALED_EPOCHS, BF16_TIMED_EPOCHS
    cfg = scaled_bf16_config(E, "timed_bf16")
    loaders = {s: create_data_loaders(base_seed=1 + s, device=dev,
                                      **cfg["data"]) for s in BF16_SEEDS}

    def trainer(up, cdt, seed: int = 0) -> Trainer:
        m = scaled_model(dev, up, seed, cdt)
        return Trainer(m, make_adam(m.parameters(), 1e-3, 5e-4),
                       ignore_first_continuity=True,
                       moment_weights=list(SCALED_MW), use_train_kernel=False)

    def epochs(tr, n, seed: int = 0):
        return timed_epochs(tr, *loaders[seed], cfg, n, SCALED_BS)

    def val(tr):
        return val_metrics(tr.model, dev, SCALED_MW, n=SCALED_VAL,
                           obs_fraction=0.02)
    if not scaled_model(dev, "auto", compute_dtype=BF16)._use_fused_step(
            2, SCALED_BS):
        raise AssertionError("'auto' does not take rows 9b-10b at the bf16 "
                             "scaled recipe's shape")
    reset_counts()
    bf = trainer("step", BF16)
    bf_s = epochs(bf, E)
    launches = expect_counts("the bf16 recipe", {
        "9b": E * SCALED_STEPS + E + 1, "10b": E * SCALED_STEPS})
    mse = {("bf16", 0): val(bf)}
    for name, cdt in (("bf16", BF16), ("f32", None)):
        for seed in BF16_SEEDS:
            if (name, seed) not in mse:
                tr = trainer("step", cdt, seed)
                epochs(tr, E, seed)
                mse[name, seed] = val(tr)
    arms = {"bf16 kernels": bf, "f32 kernels": trainer("step", None),
            "bf16 composed": trainer(False, BF16)}
    for tr in arms.values():
        epochs(tr, 1)
    turns = {k: [] for k in arms}
    for k in ("bf16 kernels", "f32 kernels", "bf16 composed",
              "bf16 composed", "f32 kernels", "bf16 kernels"):
        turns[k].append(epochs(arms[k], n_t) * E / n_t)
    ahead = max(turns["bf16 kernels"]) < min(turns["bf16 composed"])
    prof = {k: profiled_epochs(tr, loaders[0], cfg, 2)
            for k, tr in arms.items()}

    gen = torch.Generator().manual_seed(17)
    c = step_case(gen, SCALED_H, 2, False, 1, "relu", "identity", SCALED_BS,
                  dev)
    c_val = step_case(gen, SCALED_H, 2, False, 1, "relu", "identity",
                      SCALED_VAL, dev)
    args = ("relu", "identity")
    with torch.no_grad():
        run = {(k, b): (lambda k=k, b=b: (step_bwd if b else step_fwd)(
            c, *args, k, BF16)) for k in (True, False) for b in (False, True)}
        t = {key: [] for key in run}
        for key in ((True, False), (False, False), (True, True),
                    (False, True)) * 2:
            t[key].append(time_ms(run[key], warmup=3, reps=20))
        f_val = time_ms(lambda: step_fwd(c_val, *args, True, BF16))
    med = {key: statistics.median(v) for key, v in t.items()}
    flops = step_flops(SCALED_H, 2, c["lo"], SCALED_BS)
    # W in bf16, the rest f32: each input read once, each output written
    # once
    io = (2 * c["W"].numel() + 4 * (c["V"].numel() + c["times"].numel()
                                    + c["values"].numel()))
    f_bound = bound_of(flops, io + 4 * c["gy"].numel(), PEAK_BF16_FLOPS)
    b_bound = bound_of(3 * flops, io + 4 * (c["gy"].numel() + c["W"].numel()
                                            + c["V"].numel()),
                       PEAK_BF16_FLOPS)
    n = E * SCALED_TRAIN

    def fmt(xs, unit="s"):
        return ", ".join(f"{x:.4f}" for x in xs) + f" {unit}"
    print(f"bf16 scaled times on {card}: the bf16 recipe ({E} epochs x "
          f"{SCALED_TRAIN:,} fresh trajectories, batch {SCALED_BS}, hidden "
          f"{SCALED_H}, validation {SCALED_VAL:,}) through Trainer.train on "
          f"rows 9b-10b {bf_s:.3f} s = {n / bf_s:.0f} traj/s (final train "
          f"loss {bf.train_losses[E - 1]:.4f}); launches by row over the run "
          f"{launches}; in turns after a warm-up epoch, {n_t} epochs scaled "
          f"to {E}: bf16 kernels {fmt(turns['bf16 kernels'])}, f32 kernels "
          f"{fmt(turns['f32 kernels'])}, composed bf16 "
          f"{fmt(turns['bf16 composed'])} (cuBLAS bf16, f32 accumulation); "
          f"the A/B behind 'auto': the bf16 kernels "
          f"{'ahead of' if ahead else 'not ahead of'} the composed bf16 path "
          f"in every turn", flush=True)
    print("profiled, 2 epochs each after the turns (torch.profiler): " +
          "; ".join(f"{k}: wall {w:.1f} ms an epoch, device {d:.1f} ms, "
                    f"idle {100.0 * i:.1f}%, {n_l:.1f} device launches an "
                    f"epoch" for k, (w, d, i, n_l) in prof.items()),
          flush=True)
    print("val MSE after the recipe (" + f"{SCALED_VAL:,} trajectories; "
          "mean, var, relative loss): " + "; ".join(
              f"{name} seed {seed} {m[0]:.3e} / {m[1]:.3e} / {m[2]:.4f}"
              for (name, seed), m in sorted(mse.items())), flush=True)
    print(f"rows 9b-10b on {card}, two networks, H {SCALED_H}, N 2, "
          f"{SCALED_BS} rows: forward {fmt(t[True, False], 'ms')} (plain "
          f"{fmt(t[False, False], 'ms')}; bound {f_bound[0]:.4f} ms "
          f"{f_bound[1]}); backward {fmt(t[True, True], 'ms')} (plain "
          f"{fmt(t[False, True], 'ms')}; bound {b_bound[0]:.4f} ms "
          f"{b_bound[1]}); forward at {SCALED_VAL:,} validation rows "
          f"{f_val:.4f} ms", flush=True)
    return {"fused_step_fwd_bf16": (med[True, False], med[False, False],
                                    *f_bound),
            "fused_step_bwd_bf16": (med[True, True], med[False, True],
                                    *b_bound)}


# ------------- bf16 products of the whole-run kernels (rows 11b-12b, 13b)

# rows 11b-12b and 13b against their plain versions: both round the same
# operands to bf16 and sum products exact in f32, in other orders; where
# that moves a downstream operand across a bf16 rounding boundary it moves
# by one bf16 ulp (2^-8 relative) and carries on through the steps, and
# Adam's normalised step turns a changed gradient entry near zero into a
# parameter change of up to lr.  Each case is held three ways: per-step
# losses entrywise at MXU_LOSS_RTOL / ATOL; params, Adam m and v each within
# MXU_STATE_RTOL of its norm; and the ratio test of
# tests/test_torch_mxu_bf16.py, the kernel's largest distance from the plain
# bf16 run, in the losses and in the params, at most MXU_RATIO x the plain
# bf16 run's largest distance from the plain f32 run.  The ratio test pins
# where the kernel rounds: the bf16 mode moves the params about 1e-3 of
# their norm, so a kernel that rounded elsewhere would sit near the f32
# run.  As a control the f32 instance, on the same input, must fail them.
# The plain version summed in f32 against its float64 run with the same
# rounding points stays far inside these limits (printed).
MXU_LOSS_RTOL, MXU_STATE_RTOL, MXU_RATIO = 5e-4, 1e-4, 0.1
MXU = "bfloat16"


def mxu_shares(ours, ref, ref32=None) -> dict:
    """A bf16 run's (state, losses) against its plain version's: each
    check's share of its limit (above 1 fails), with the ratio test's where
    the plain f32 run ref32 is given."""
    la, lb = ours[1].cpu().double(), ref[1].cpu().double()
    if not torch.isfinite(la).all() or not all(
            torch.isfinite(x).all() for x in ours[0]):
        return {"finite": math.inf}
    out = {"losses": float(((la - lb).abs() / (ATOL + MXU_LOSS_RTOL
                                              * lb.abs())).max())}
    for name, x, y in (("params", ours[0].params, ref[0].params),
                       ("Adam m", ours[0].m, ref[0].m),
                       ("Adam v", ours[0].v, ref[0].v)):
        x, y = x.cpu().double(), y.cpu().double()
        out[name] = float((x - y).norm() / y.norm().clamp_min(1e-30)
                          / MXU_STATE_RTOL)
    if ref32 is not None:
        for name, a, b, c in (("ratio losses", la, lb, ref32[1]),
                              ("ratio params", ours[0].params,
                               ref[0].params, ref32[0].params)):
            a, b, c = (x.cpu().double() for x in (a, b, c))
            gap = float((b - c).abs().max())     # 0: the mode is not real
            out[name] = (float((a - b).abs().max()) / (MXU_RATIO * gap)
                         if gap > 0 else math.inf)
    return out


def mxu_bf16_check(run, run_plain, state, data, kw, where: str) -> tuple:
    """One case: the bf16 kernel against the plain bf16 and f32 runs
    (limits, ratio test), then the f32 instance as the control that must
    fail them.  Returns (largest abs err, the shares, the control's largest
    share)."""
    f32 = {**kw, "mxu_dtype": "float32"}
    with torch.no_grad():
        ours = run(state, data, **kw)
        ctrl = run(state, data, **f32)
        torch.cuda.synchronize()
    ref, ref32 = run_plain(state, data, **kw), run_plain(state, data, **f32)
    shares = mxu_shares(ours, ref, ref32)
    bad = {k: v for k, v in shares.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"bf16 {where}: beyond the limits (share of "
                             f"each): {bad}")
    ctrl_worst = max(mxu_shares(ctrl, ref, ref32).values())
    if ctrl_worst <= 1.0:
        raise AssertionError(f"bf16 {where}: the f32 instance passes the "
                             f"bf16 checks too (largest share "
                             f"{ctrl_worst:.3f}); they cannot tell the modes "
                             f"apart")
    err = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in
              ((ours[1], ref[1]), *zip(ours[0][:3], ref[0][:3])))
    return err, shares, ctrl_worst


def mxu_f64_shares(run_plain, state, data, kw) -> dict:
    """The plain version's own spread: its f32 run against its float64 run
    (same rounding points), as shares of the bf16 limits."""
    with torch.no_grad():
        f32 = run_plain(state, data, **kw)
        f64 = run_plain(type(state)(*(x.double() for x in state)),
                        data.double(), **kw)
    return mxu_shares(f32, f64)


def bf16_instances(name: str) -> str:
    """ptxas's line of each bf16 instance (the last template flag set)."""
    return "; ".join(e for e in ptxas_instances(name).split("; ")
                     if e.split(">")[0].endswith(", 1")) or "no ptxas output"


def mxu_bf16_kernel_phase(dev: torch.device) -> tuple[float, float]:
    """Phase 27: rows 11b-12b and 13b against their plain versions on the
    card, on a subset of phases 8 and 13's cases with both recipes' own
    shapes and a trajectory-masked last minibatch, at the bf16 limits and
    the ratio test (the worst share of each printed), with the f32
    instance failing them as the control; two calls bitwise equal at each
    recipe's shape.  Returns each row's largest abs err."""
    relu = dict(act="relu", scale="identity")
    run_cases = [dict(K=2, H=32, method="direct", **relu),
                 dict(K=1, H=64, method="second_moment", act="tanh",
                      scale="tanh"),
                 dict(K=2, H=128, method="direct", act="selu",
                      scale="identity"),
                 dict(K=2, H=50, method="second_moment", **relu),
                 dict(K=2, H=32, method="direct", bs=13, **relu),
                 dict(K=2, H=32, method="direct", bs=1024, **relu),
                 dict(K=2, H=128, method="direct", obs_fraction=0.25, G=2,
                      **relu)]
    worst = {"11b": [0.0, {}, math.inf], "13b": [0.0, {}, math.inf]}

    def fold(row, err, shares, ctrl):
        w = worst[row]
        w[0] = max(w[0], err)
        for k, v in shares.items():
            w[1][k] = max(w[1].get(k, 0.0), v)
        w[2] = min(w[2], ctrl)
    plans = {}
    for i, c in enumerate(run_cases):
        state, data, kw = train_kernel_case(dev, **c)
        kw["mxu_dtype"] = MXU
        plan = tk.launch_plan(c["H"], kw["n_slots"], kw["batch_size"],
                              c["scale"], c["K"])
        plans[(c["H"], kw["n_slots"], kw["batch_size"])] = tuple(plan)
        fold("11b", *mxu_bf16_check(tk.fused_train_run,
                                    tk.fused_train_run_reference, state,
                                    data, kw, f"at {c} (plan {plan})"))
        if i == 0:              # the default recipe's shape
            spread11 = mxu_f64_shares(tk.fused_train_run_reference, state,
                                      data, kw)
            bitwise_twice(lambda: tk.fused_train_run(state, data, **kw),
                          "rows 11b-12b")
    walk_cases = [(2, "direct", "euler", PROD_BS, 8, PROD_H, relu),
                  (1, "second_moment", "heun", 64, 3, PROD_H, relu),
                  (2, "direct", "rk4", 64, 3, PROD_H, relu),
                  (2, "second_moment", "euler", 64, 3, PROD_H,
                   dict(act="tanh", scale="tanh")),
                  (2, "direct", "rk4", WIDE_BS, 2, WIDE_H, relu)]
    for i, (K, method, solver, bs, G, hidden, act) in enumerate(walk_cases):
        model = walk_model(dev, K, solver, seed=K + G, hidden=hidden)
        data = train_data(dev, G * bs, bs, 61 + i, n_valid=G * bs - bs // 3)
        kw = walk_train_kwargs(K, method, solver, bs, hidden)
        kw.update(activation=act["act"], input_scaling=act["scale"],
                  mxu_dtype=MXU)
        state = wt.init_walk_state(model)
        where = (f"walk-train K={K} {method} {solver} {act['act']} "
                 f"H={hidden} batch {bs}")
        fold("13b", *mxu_bf16_check(wt.fused_walk_train_run,
                                    wt.fused_walk_train_run_reference, state,
                                    data, kw, where))
        if i == 0:              # the production recipe's shape
            spread13 = mxu_f64_shares(wt.fused_walk_train_run_reference,
                                      state, data, kw)
            bitwise_twice(lambda: wt.fused_walk_train_run(state, data, **kw),
                          "row 13b")

    def fmt(d):
        return ", ".join(f"{k} {v:.3f}" for k, v in d.items())
    print(f"bf16 whole-run kernels vs plain: rows 11b-12b over "
          f"{len(run_cases)} cases (K 1/2, H 32/50/64/128, relu/tanh/selu, "
          f"direct/second_moment, batch 128/13/1,024, H 128 at N 25; plans "
          f"{plans}), row 13b over {len(walk_cases)} (8 steps at the "
          f"production shape; heun, rk4, tanh/tanh at batch 64; H {WIDE_H} "
          f"batch {WIDE_BS} rk4 chunked); last minibatch a third masked: "
          f"losses at rtol {MXU_LOSS_RTOL} / atol {ATOL}, params, m, v each "
          f"within {MXU_STATE_RTOL} of its norm, ratio test at {MXU_RATIO}; "
          f"worst shares of those limits: 11b {fmt(worst['11b'][1])}; 13b "
          f"{fmt(worst['13b'][1])}; max abs err 11b {worst['11b'][0]:.3e}, "
          f"13b {worst['13b'][0]:.3e}; the control (the f32 instance on the "
          f"same input) fails every case, its largest share at least "
          f"11b {worst['11b'][2]:.3f}, 13b {worst['13b'][2]:.3f}; the plain "
          f"versions' own f32-vs-float64 shares at the recipes' shapes: 11b "
          f"{fmt(spread11)}; 13b {fmt(spread13)}; two calls bitwise equal at "
          f"both", flush=True)
    print(f"ptxas, bf16 instances: train_run.cu <columns a lane, all in "
          f"shared memory, bf16> {bf16_instances('train_run')}; "
          f"walk_train.cu <columns a lane, stages, relu/identity compiled "
          f"in, bf16> {bf16_instances('walk_train')}", flush=True)
    return worst["11b"][0], worst["13b"][0]


def mxu_bf16_path_phase(dev: torch.device, tmp: Path) -> dict:
    """Phase 28: run_experiment of the default and the production configs
    with train_kernel_mxu "bfloat16" (build_config of their CLI flags plus
    --train-kernel-mxu bfloat16), 3 epochs then resumed to 4, each in its
    own window: rows 11b / 13b once an epoch, rows 11-13 in f32 and rows
    2-10 not at all, row 1 only in the production validation.  Returns the
    windows' counts by row."""
    got = {}
    for row, cfg_of, extra in (("11b", default_config, {}),
                               ("13b", production_config, {1: None})):
        reset_counts()
        res = run_experiment(dict(cfg_of(3, f"mxu_{row}"),
                                  train_kernel_mxu=MXU), save_dir=str(tmp))
        torch.cuda.synchronize()
        expect_counts(f"the bf16 {row} recipe, 3 epochs", {row: 3, **extra})
        hist = res["history"]["train_loss"]
        if len(hist) != 3 or not all(math.isfinite(x) for x in
                                     hist + res["history"]["val_loss"]):
            raise AssertionError(f"bf16 {row} losses {res['history']}")
        res4 = run_experiment(dict(cfg_of(4, f"mxu_{row}"),
                                   train_kernel_mxu=MXU), save_dir=str(tmp))
        torch.cuda.synchronize()
        got[row] = expect_counts(f"the bf16 {row} recipe resumed to 4",
                                 {row: 4, **extra})
        hist4 = res4["history"]["train_loss"]
        if len(hist4) != 4 or hist4[:3] != hist:
            raise AssertionError(f"the resume gave {hist4} after {hist}")
        saved = json.loads((tmp / f"mxu_{row}" / "config.json").read_text())
        if saved.get("train_kernel_mxu") != MXU:
            raise AssertionError(f"saved config {saved}")
        recipe = "default" if row == "11b" else "production"
        print(f"bf16 training path ({recipe} config, train_kernel_mxu "
              f"bfloat16): run_experiment 3 epochs, "
              f"train loss {hist[0]:.4f} -> {hist[-1]:.4f}, val "
              f"{res['history']['val_loss'][-1]:.4f}; resumed to 4 (loss "
              f"{hist4[-1]:.4f}); launches in the window by row {got[row]}",
              flush=True)
    return got


def mxu_bf16_times_phase(dev: torch.device, card: str) -> dict:
    """Phase 29: rows 11b and 13b per epoch call against rows 11 and 13 in
    turns (f32, bf16, bf16, f32), their plain versions and bounds at the
    bf16 peak; both bf16 recipes through Trainer.train in turns with the
    f32 recipes (f32 at seed 0, bf16 at 0, bf16 at 1, f32 at 1), each run's
    launches checked, and val MSE of each (reported, not gated).  Returns
    each bf16 kernel's (ms, plain ms, bound ms, bound_by)."""
    out, lines = {}, []
    # rows 11 / 11b: an epoch call of the default recipe (8 steps of 128)
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(0))
    d_data = train_data(dev, 1024, TRAIN_BS, 3, n_valid=1000)
    d_state, d_kw = tk.init_train_state(model), train_kwargs(2)
    H, K, S = 32, 2, TRAIN_N - 1
    fwd = K * 2 * (TRAIN_N * (H + H * H) + (2 * TRAIN_N - 1) * (H * H + H)
                   + S * ((H + 3) * H + H * H))
    P = tk.n_params_per_net(H)
    d_bound = bound_of(3 * fwd * 1000, 4 * (d_data.numel() + 6 * K * P + 4
                                            + 8), PEAK_BF16_FLOPS)
    # rows 13 / 13b: an epoch call of the production recipe (40 of 256)
    n_rows = -(-PROD_TRAIN // PROD_BS) * PROD_BS
    p_data = train_data(dev, n_rows, PROD_BS, 51, n_valid=PROD_TRAIN)
    p_state = wt.init_walk_state(walk_model(dev, seed=0))
    p_kw = walk_train_kwargs(2, "direct", "euler", PROD_BS)
    pf = 2 * (PROD_N * (PROD_H + PROD_H ** 2)
              + (2 * PROD_N - 1) * (PROD_H ** 2 + 2 * PROD_H)
              + PROD_M * ((PROD_H + 3) * PROD_H + PROD_H ** 2))
    WP = wt.n_params(PROD_H, 2)
    p_bound = bound_of(3 * pf * PROD_TRAIN,
                       4 * (p_data.numel() + 6 * WP + 4 + n_rows // PROD_BS),
                       PEAK_BF16_FLOPS)
    for row, kernel, plain, state, data, kw, bound in (
            ("11b", tk.fused_train_run, tk.fused_train_run_reference,
             d_state, d_data, d_kw, d_bound),
            ("13b", wt.fused_walk_train_run,
             wt.fused_walk_train_run_reference, p_state, p_data, p_kw,
             p_bound)):
        t = {"float32": [], MXU: []}
        with torch.no_grad():
            for mode in ("float32", MXU, MXU, "float32"):
                t[mode].append(time_ms(lambda: kernel(
                    state, data, **{**kw, "mxu_dtype": mode}), warmup=2,
                    reps=10))
            p_ms = time_ms(lambda: plain(state, data, **{**kw,
                                                         "mxu_dtype": MXU}),
                           warmup=1, reps=2 if row == "11b" else 1)
        ms = statistics.median(t[MXU])
        out[row] = (ms, p_ms, *bound)
        lines.append(
            f"row {row} {', '.join(f'{x:.4f}' for x in t[MXU])} ms against "
            f"row {row[:-1]} {', '.join(f'{x:.4f}' for x in t['float32'])} "
            f"ms (in turns f32, bf16, bf16, f32); plain {p_ms:.3f} ms; bound "
            f"{bound[0]:.4f} ms ({bound[1]}, bf16 peak)")
    print(f"bf16 whole-run kernels on {card}, an epoch call (11b: 8 steps of "
          f"128, H 32, K 2; 13b: 40 steps of 256, H {PROD_H}, M {PROD_M}): "
          + "; ".join(lines), flush=True)

    # the recipes through Trainer.train, f32 and bf16 in turns over seeds
    recipes = {
        "default": dict(cfg=default_config(TRAIN_EPOCHS, "timed"),
                        row=11, H=32, shared=False, dt=None, bs=TRAIN_BS,
                        mw=(1.0, 10.0), extra={}),
        "production": dict(cfg=production_config(PROD_EPOCHS, "timed"),
                           row=13, H=PROD_H, shared=True, dt=PROD_DT,
                           bs=PROD_BS, mw=PROD_MW, extra={1: None})}
    rec_lines = []
    for name, r in recipes.items():
        E = r["cfg"]["n_epochs"]
        n = r["cfg"]["data"]["n_train"]
        secs, mse = {"float32": [], MXU: []}, {}
        for mode, seed in (("float32", 0), (MXU, 0), (MXU, 1),
                           ("float32", 1)):
            m = NeuralJumpODE(1, r["H"], 1, num_moments=2,
                              shared_network=r["shared"],
                              dt_ode_step=r["dt"], t_max=1.0,
                              grid_walk=r["dt"] is not None, device=dev,
                              generator=torch.Generator().manual_seed(seed))
            tr = Trainer(m, make_adam(m.parameters(), 1e-3, 5e-4),
                         ignore_first_continuity=True,
                         moment_weights=list(r["mw"]), use_train_kernel=True,
                         train_kernel_opts={"mxu_dtype": mode})
            loaders = create_data_loaders(base_seed=1 + seed, device=dev,
                                          **r["cfg"]["data"])
            reset_counts()
            secs[mode].append(timed_epochs(tr, *loaders, r["cfg"], E,
                                           r["bs"]))
            row = f"{r['row']}b" if mode == MXU else r["row"]
            expect_counts(f"the {name} recipe, {mode}", {row: E,
                                                        **r["extra"]})
            mse[mode, seed] = val_metrics(m, dev, r["mw"])
        rec_lines.append(
            f"{name} ({E} epochs x {n:,} fresh trajectories): bf16 "
            f"{', '.join(f'{x:.3f}' for x in secs[MXU])} s, f32 "
            f"{', '.join(f'{x:.3f}' for x in secs['float32'])} s (in turns "
            f"f32 seed 0, bf16 seed 0, bf16 seed 1, f32 seed 1); val MSE "
            f"mean / var: " + ", ".join(
                f"{'bf16' if k == MXU else 'f32'} seed {sd} {v[0]:.3e} / "
                f"{v[1]:.3e}" for (k, sd), v in sorted(mse.items())))
    print(f"bf16 recipes on {card} through Trainer.train with the whole-run "
          f"kernels: " + "; ".join(rec_lines), flush=True)
    return out


def kernel_counts() -> dict:
    """Every kernel's launch count, by its row in the TPU kernel table
    (row 12 is row 11's kernel; 9b, 10b, 11b and 13b the bf16 instances of
    rows 9, 10, 11-12 and 13)."""
    return {1: gap_scan.LAUNCHES, 2: gap_scan.LAUNCHES_RES_FWD["full"],
            3: gap_scan.LAUNCHES_RES_FWD["checkpointed"],
            4: gap_scan.LAUNCHES_BWD["full"],
            5: gap_scan.LAUNCHES_BWD["checkpointed"], 6: fused_cell.LAUNCHES,
            7: walk_scan.LAUNCHES_FWD, 8: walk_scan.LAUNCHES_BWD,
            9: fs.LAUNCHES_FWD, 10: fs.LAUNCHES_BWD,
            "9b": fs.LAUNCHES_FWD_BF16, "10b": fs.LAUNCHES_BWD_BF16,
            11: tk.LAUNCHES, 13: wt.LAUNCHES, "11b": tk.LAUNCHES_BF16,
            "13b": wt.LAUNCHES_BF16}


def reset_counts() -> None:
    gap_scan.LAUNCHES = fused_cell.LAUNCHES = tk.LAUNCHES = wt.LAUNCHES = 0
    tk.LAUNCHES_BF16 = wt.LAUNCHES_BF16 = 0
    walk_scan.LAUNCHES_FWD = walk_scan.LAUNCHES_BWD = 0
    fs.LAUNCHES_FWD = fs.LAUNCHES_BWD = 0
    fs.LAUNCHES_FWD_BF16 = fs.LAUNCHES_BWD_BF16 = 0
    for counter in (gap_scan.LAUNCHES_RES_FWD, gap_scan.LAUNCHES_BWD):
        for mode in counter:
            counter[mode] = 0


def expect_counts(window: str, want: dict) -> dict:
    """The launch counts of a window: each row in ``want`` exactly its
    value (None: at least once), every other row 0."""
    got = kernel_counts()
    bad = {row: n for row, n in got.items()
           if (row not in want and n) or (row in want and (
               n == 0 if want[row] is None else n != want[row]))}
    if bad:
        raise AssertionError(f"{window}: launches by row {got}, expected "
                             f"{want} and 0 elsewhere")
    return got


def forced_production_config(n_epochs: int, name: str,
                             dt: float = PROD_DT) -> dict:
    """The production config under --kernels force (use_pallas True) on the
    per-gap path (--grid-walk off), at --dt-ode-step dt."""
    return recipe_config("production", n_epochs, name, "--kernels", "force",
                         "--grid-walk", "off", "--dt-ode-step", str(dt))


def forced_default_config(n_epochs: int, name: str) -> dict:
    """The default config under --kernels force (use_pallas True)."""
    return recipe_config("default", n_epochs, name, "--kernels", "force")


PROD_STEPS = -(-PROD_TRAIN // PROD_BS)          # 40
DEFAULT_STEPS = -(-1000 // TRAIN_BS)            # 8


def forced_production_path_phase(dev: torch.device, tmp: Path) -> dict:
    """run_experiment of the forced production config, 2 epochs then a
    resume to 3.  The caller resets the counts before: rows 3 and 5 launch
    once a step, row 1 in validation and the relative loss, nothing else."""
    res = run_experiment(forced_production_config(2, "forced_prod"),
                         save_dir=str(tmp))
    hist = res["history"]["train_loss"]
    if len(hist) != 2 or not all(math.isfinite(x) for x in
                                 hist + res["history"]["val_loss"]):
        raise AssertionError(f"forced production losses {res['history']}")
    res3 = run_experiment(forced_production_config(3, "forced_prod"),
                          save_dir=str(tmp))
    torch.cuda.synchronize()
    hist3 = res3["history"]["train_loss"]
    if len(hist3) != 3 or hist3[:2] != hist:
        raise AssertionError(f"the resume to 3 epochs gave {hist3} after "
                             f"{hist}")
    got = expect_counts("forced production run_experiment",
                        {3: 3 * PROD_STEPS, 5: 3 * PROD_STEPS, 1: None})
    print(f"forced production training path: run_experiment (hidden "
          f"{PROD_H}, shared, K=2, dt {PROD_DT}, batch {PROD_BS}, "
          f"{PROD_TRAIN:,} fresh trajectories per epoch, use_pallas True, "
          f"grid_walk off) 2 epochs: train loss {hist[0]:.4f} -> "
          f"{hist[-1]:.4f}, val {res['history']['val_loss'][-1]:.4f}; "
          f"resumed to 3 (loss {hist3[-1]:.4f}); launches in this window by "
          f"row: {got}", flush=True)
    return got


def forced_vs_composed_phase(dev: torch.device, forced_cfg: dict,
                             model_kw: dict, mw, bs: int, name: str) -> float:
    """One epoch of identical data (the config's law and size, its
    minibatches of bs, the last trajectory-masked) through apply_loss +
    autograd + Adam on the forced kernels (use_pallas True) and on the
    composed path (False), from identical weights: per-step losses and the
    parameters after the epoch at rtol 1e-4 / atol 1e-5 (phase 14's)."""
    train_fn, _ = create_data_loaders(base_seed=9, device=dev,
                                      **forced_cfg["data"])
    times, values, mask, _ = as_dense(train_fn(0), dev)
    losses, params = [], []
    for up in (True, False):
        model = NeuralJumpODE(use_pallas=up, device=dev,
                              generator=torch.Generator().manual_seed(12),
                              **model_kw)
        tr = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True, moment_weights=list(mw),
                     use_train_kernel=False)
        idx, valid = tr._minibatches(0, times.shape[0], bs, True)
        step_losses = []
        for ids, vm in zip(idx, valid):
            tr.optimizer.zero_grad(set_to_none=True)
            loss = tr._loss(times[ids], values[ids], mask[ids], traj_mask=vm,
                            training=True)
            loss.backward()
            tr.optimizer.step()
            step_losses.append(loss.detach())
        losses.append(torch.stack(step_losses))
        params.append({k: v.detach() for k, v in model.named_parameters()})
    err = assert_close(losses[0], losses[1],
                       f"{name}: forced vs composed per-step losses")
    err = max([err] + [assert_close(params[0][k], params[1][k],
                                    f"{name}: forced vs composed {k}")
                       for k in params[1]])
    print(f"{name}, forced kernels vs composed path: one epoch "
          f"({len(losses[0])} steps of {bs}) from identical weights, "
          f"per-step losses and parameters max abs err {err:.3e}",
          flush=True)
    return err


PROD_MODEL_KW = dict(input_dim=1, hidden_dim=PROD_H, output_dim=1,
                     num_moments=2, shared_network=True, dt_ode_step=PROD_DT,
                     t_max=1.0)
DEFAULT_MODEL_KW = dict(input_dim=1, hidden_dim=32, output_dim=1,
                        num_moments=2)


def forced_default_path_phase(dev: torch.device, tmp: Path) -> dict:
    """run_experiment of the forced default config for 3 epochs.  The
    caller resets the counts before: row 6 launches once per apply (8 steps
    an epoch, one validation an epoch, one relative loss at epoch 0), the
    training kernel never."""
    res = run_experiment(forced_default_config(3, "forced_default"),
                         save_dir=str(tmp))
    torch.cuda.synchronize()
    hist = res["history"]["train_loss"]
    if len(hist) != 3 or not all(math.isfinite(x) for x in
                                 hist + res["history"]["val_loss"]):
        raise AssertionError(f"forced default losses {res['history']}")
    got = expect_counts("forced default run_experiment",
                        {6: 3 * DEFAULT_STEPS + 3 + 1})
    print(f"forced default training path: run_experiment (hidden 32, K=2 "
          f"separate, batch {TRAIN_BS}, 1,000 fresh trajectories per epoch, "
          f"use_pallas True) 3 epochs: train loss {hist[0]:.4f} -> "
          f"{hist[-1]:.4f}, val {res['history']['val_loss'][-1]:.4f}; "
          f"launches in this window by row: {got}", flush=True)
    return got


def full_residual_window_phase(dev: torch.device, tmp: Path) -> dict:
    """run_experiment of the forced production config with dt_ode_step 0.1
    for one epoch: 10 substeps, so the full-residual pair (rows 2 and 4)
    once a step and not the checkpointed one; the grid (0.01 / 0.1) is not
    aligned, so no walk."""
    res = run_experiment(forced_production_config(1, "forced_dt01", dt=0.1),
                         save_dir=str(tmp))
    torch.cuda.synchronize()
    if not math.isfinite(res["final_train_loss"]):
        raise AssertionError(f"dt 0.1 forced loss {res['history']}")
    got = expect_counts("forced dt 0.1 run_experiment",
                        {2: PROD_STEPS, 4: PROD_STEPS, 1: None})
    print(f"dt_ode_step 0.1 forced window: run_experiment, one epoch of "
          f"{PROD_TRAIN:,} (loss {res['final_train_loss']:.4f}); launches "
          f"by row: {got}", flush=True)
    return got


def forced_rows(model: NeuralJumpODE, times, values, dt: float) -> tuple:
    """The training pair's arguments as the forced apply builds them for a
    minibatch (one gap a row, slot i-1 -> i), with dt as the step."""
    B, N = times.shape
    with torch.no_grad():
        h_j = model._jump(values.reshape(B * N, 1))
        K, d = h_j.shape[0], h_j.shape[-1]
        h0 = h_j.reshape(K, B, N, d)[:, :, :-1].reshape(K, B * (N - 1), d)
        x = values[:, :-1].reshape(-1, 1)
        w = gap_scan.split_weights(model._ode_weights())
        return gap_scan.substep_inputs(
            h0, model._scale(x), times[:, :-1].reshape(-1),
            times[:, 1:].reshape(-1), w, dt)


def gap_train_bounds(args: tuple, dt: float, n_sub: int,
                     stride: int) -> tuple:
    """Least times of the training pair on the H100 for one call: the
    larger of the f32 work of the substeps these gaps take (forward 4 d^2
    + 4 d a row, network and substep; backward 10 d^2: pre again, g_dh
    W2^T, g_pre W1h^T, dW1h and dW2, and 2 d^2 more for the checkpointed
    recompute, whose W1h product is that pre and whose W2 product rebuilds
    the next state) over 67 TFLOP/s and the bytes in and out once over
    3.35 TB/s."""
    h, base, t_last, t_target, w1h, w1t, w2, b2 = args
    K, R, d = h.shape
    with torch.no_grad():
        _, t_l = gap_scan.gap_substeps_reference(*args, dt, n_sub, "relu",
                                                 "identity")
    steps = float(torch.round((t_l - t_last) / dt).sum())
    n_res = -(-n_sub // stride)
    w_bytes = 4 * (w1h.numel() + w1t.numel() + w2.numel() + b2.numel())
    res_bytes = 4 * n_res * (K * R * d + R)
    f_bytes = 4 * (3 * K * R * d + 3 * R) + w_bytes + res_bytes
    b_bytes = 4 * (6 * K * R * d + R + 2 * K * d * d) + w_bytes + res_bytes
    recompute = 2 * d * d if stride > 1 else 0
    return (bound_of(K * steps * (4 * d * d + 4 * d), f_bytes),
            bound_of(K * steps * (10 * d * d + recompute), b_bytes))


def forced_times_phase(dev: torch.device, card: str) -> dict:
    """One epoch of each forced path against its composed twin, in turns
    (forced, composed, composed, forced) after a warm-up epoch each; rows
    2-6 per call at their main-path shapes by CUDA events against their
    plain versions and bounds, rows 2-5 also held against them there
    (gap_pair_check); the residual-stride A/B at n_sub 100.  Returns each
    row's (ms, plain ms, bound ms, bound_by) and the (forward, backward)
    max abs err of each residual mode at the main path's shape."""
    out = {}
    epochs = {}
    for name, cfg, kw, mw, bs in (
            ("production", forced_production_config(4, "timed"),
             PROD_MODEL_KW, PROD_MW, PROD_BS),
            ("default", forced_default_config(4, "timed"), DEFAULT_MODEL_KW,
             (1.0, 10.0), TRAIN_BS)):
        train_fn, val_fn = create_data_loaders(base_seed=1, device=dev,
                                               **cfg["data"])
        trainers = {}
        for up in (True, False):
            m = NeuralJumpODE(use_pallas=up, device=dev,
                              generator=torch.Generator().manual_seed(0),
                              **kw)
            trainers[up] = Trainer(m, make_adam(m.parameters(), 1e-3, 5e-4),
                                   ignore_first_continuity=True,
                                   moment_weights=list(mw),
                                   use_train_kernel=False)
            timed_epochs(trainers[up], train_fn, val_fn, cfg, 1, bs)
        t = {True: [], False: []}
        for up in (True, False, False, True):
            t[up].append(timed_epochs(trainers[up], train_fn, val_fn, cfg, 1,
                                      bs))
        epochs[name] = t

    # rows 3 and 5 (and the stride A/B) on a production minibatch, rows 2
    # and 4 on the same minibatch at dt 0.1
    gen = torch.Generator(device=dev).manual_seed(33)
    b = simulate_batch(PROD_BS, "black_scholes", 0.1, True, generator=gen,
                       device=dev, mu=0.1, sigma=0.5, x0=1.0)
    model = NeuralJumpODE(use_pallas=True, device=dev, **PROD_MODEL_KW)
    ct = torch.randn(1, PROD_BS * (PROD_N - 1), PROD_H, device=dev)
    # each row's call, profiled at the end (a profiler session slows the
    # host's launches after it)
    ab, errs, calls = {}, {}, {}

    def pair_times(dt, n_sub, stride):
        args = forced_rows(model, b.times, b.values, dt)
        fwd = (*args, dt, n_sub, stride, "relu", "identity")
        with torch.no_grad():
            res = gap_scan._launch_train_fwd(*fwd)
            bwd = (ct, args[1], args[3], *args[4:], res[2], res[3], dt,
                   n_sub, stride, "relu", "identity")
            f_ms = time_ms(lambda: gap_scan._launch_train_fwd(*fwd))
            b_ms = time_ms(lambda: gap_scan._launch_train_bwd(*bwd))
        return args, bwd, f_ms, b_ms
    for stride in STRIDES_AB + STRIDES_AB[::-1]:
        _, _, f_ms, b_ms = pair_times(PROD_DT, PROD_M, stride)
        ab.setdefault(stride, []).append((f_ms, b_ms))
    for dt, n_sub, rows in ((PROD_DT, PROD_M, (3, 5)), (0.1, 10, (2, 4))):
        stride = gap_scan.residual_stride(n_sub)
        args, bwd, f_ms, b_ms = pair_times(dt, n_sub, stride)
        where = f"the main path's shape (dt {dt}, n_sub {n_sub})"
        f_err, b_err, rel, rec = gap_pair_check(
            args, ct, dt, n_sub, "relu", "identity", where)
        n_same, moved = gap_schedule_check(args, dt, n_sub, "relu",
                                           "identity", where)
        if stride > 1:
            gap_stride_bitwise_check(args, ct, dt, n_sub, "relu", "identity",
                                     where)
        errs["full" if stride == 1 else "checkpointed"] = [f_err, b_err]
        print(f"rows {rows[0]}/{rows[1]} vs plain at the main path's shape "
              f"(K_h 1, {PROD_BS * (PROD_N - 1):,} gaps, d_h {PROD_H}, dt "
              f"{dt}, n_sub {n_sub}, relu/identity): max abs err, forward "
              f"{f_err:.3e}, backward {b_err:.3e} (error/norm {rel:.3e}, "
              f"limit {GRAD_RTOL}; against the records' plain pair "
              f"{rec:.3e}, limit {RECORDS_RTOL}); t_L and stored t bitwise, "
              f"two backward calls bitwise equal; the forward on permuted "
              f"rows and on subsets that move {moved} rows to another walker "
              f"({n_same} calls) bitwise equal row by row"
              + (f"; the pair at stride 1 and at stride {stride} bitwise "
                 f"equal (h_L, t_L, shared checkpoints, every backward "
                 f"output)" if stride > 1 else ""), flush=True)
        fwd = (*args, dt, n_sub, stride, "relu", "identity")
        calls[rows[0]] = lambda fwd=fwd: gap_scan._launch_train_fwd(*fwd)
        calls[rows[1]] = lambda bwd=bwd: gap_scan._launch_train_bwd(*bwd)
        with torch.no_grad():
            fp_ms = time_ms(lambda: gap_scan.gap_train_forward_reference(
                *fwd), warmup=1, reps=5)
            bp_ms = time_ms(lambda: gap_scan.gap_train_backward_reference(
                *bwd), warmup=1, reps=5)
        f_bound, b_bound = gap_train_bounds(args, dt, n_sub, stride)
        out[rows[0]] = (f_ms, fp_ms, *f_bound)
        out[rows[1]] = (b_ms, bp_ms, *b_bound)

    # row 6 on a default minibatch (128 trajectories, 9 gaps each)
    b = simulate_batch(TRAIN_BS, "black_scholes", 0.1, True, generator=gen,
                       device=dev, mu=0.1, sigma=0.5, x0=1.0)
    m6 = NeuralJumpODE(use_pallas=True, device=dev, **DEFAULT_MODEL_KW)
    B, N = b.times.shape
    with torch.no_grad():
        h_j = m6._jump(b.values.reshape(B * N, 1))
        h0 = h_j.reshape(2, B, N, 32)[:, :, :-1].reshape(2, -1, 32)
        x = b.values[:, :-1].reshape(-1, 1)
        cell = [a.contiguous() for a in fused_cell._cell_inputs(
            h0, m6._scale(x), m6._scale(h0), b.times[:, :-1].reshape(-1),
            b.times[:, 1:].reshape(-1), m6._ode_weights())]
        args6 = (cell[0], h0.contiguous(), *cell[1:], "relu")
        c_ms = time_ms(lambda: fused_cell._launch(*args6))
        calls[6] = lambda: fused_cell._launch(*args6)
        cp_ms = time_ms(lambda: fused_cell.fused_cell_reference(*args6))
    inp, h6 = args6[0], args6[1]
    K6, R6, d_in = inp.shape
    d6 = h6.shape[-1]
    c_bytes = 4 * (inp.numel() + 3 * h6.numel() + R6
                   + sum(a.numel() for a in args6[3:7]))
    out[6] = (c_ms, cp_ms, *bound_of(2 * K6 * R6 * (d_in * d6 + d6 * d6),
                                     c_bytes))

    with torch.no_grad():
        dev_t = {r: device_time_ms(fn) for r, fn in calls.items()}

    def ms(v):
        return ", ".join(f"{x:.4f}" for x in v)
    for name, t in epochs.items():
        print(f"forced times on {card}, {name} recipe, one epoch each in "
              f"turns after a warm-up epoch (forced, composed, composed, "
              f"forced): forced kernels {ms(t[True])} s, composed per-gap "
              f"path {ms(t[False])} s", flush=True)
    rows_txt = "; ".join(
        f"row {r} {v[0]:.4f} ms (device {dev_t[r]:.4f} ms by profiler, plain "
        f"{v[1]:.4f} ms, bound {v[2]:.4f} ms {v[3]})"
        for r, v in sorted(out.items()))
    print(f"forced kernels on {card}: {rows_txt}; rows 2-5 at {PROD_BS} "
          f"trajectories x {PROD_N - 1} gaps (K_h 1, d_h {PROD_H}, relu/"
          f"identity; rows 3/5 dt {PROD_DT}, n_sub {PROD_M}; rows 2/4 dt 0.1,"
          f" n_sub 10), row 6 at {TRAIN_BS} x 9 gaps (K_h 2, d_h 32, d_in "
          f"{d_in})", flush=True)
    print(f"residual stride A/B at n_sub {PROD_M} (same minibatch, forward "
          f"/ backward ms, strides in turns {STRIDES_AB} and back): "
          + "; ".join(f"stride {s_}: " + ", ".join(
              f"{f:.4f} / {b_:.4f}" for f, b_ in v) for s_, v in ab.items()),
          flush=True)
    return out, errs


def step_build_phase(build_s: float) -> None:
    """Phase 16: fused_step.cu's registers and spill bytes by function
    (printed; section 6 of PERF.md says where the f32 instances spill) and
    its tensor-core instructions: none in the f32 kernels (CUDA-core fma),
    some in each of the three bf16 kernels."""
    inst = step_instances()
    print(f"build: fused_step.cu in {build_s:.2f} s (with the other sources, "
          f"in parallel); ptxas: {ptxas_summary('fused_step')}; by function: "
          + "; ".join(f"{k}: {'' if r is None else f'{r} registers, '}"
                      f"{sp} spill bytes" for k, (r, sp) in sorted(inst.items())),
          flush=True)
    hmma = step_tensor_core_counts()
    print("fused_step.cu tensor-core instructions (HMMA/HGMMA in the SASS) "
          "by function (the bf16 kernels on the tensor cores, the f32 "
          "instances on the CUDA cores): " + "; ".join(
              f"{k} {n}" for k, n in hmma.items()), flush=True)
    bf = [n for k, n in hmma.items() if k.startswith("bf16")]
    f32 = {k: n for k, n in hmma.items() if k.startswith("f32")}
    if len(bf) != 3 or not all(bf):
        raise AssertionError(f"a bf16 fused-step kernel runs no tensor-core "
                             f"instruction: {hmma}")
    if len(f32) < 4 or any(f32.values()):
        raise AssertionError(f"an f32 fused-step function runs tensor-core "
                             f"instructions (or is missing): {hmma}")


# ------------------------------------ the other process families and d_x 2

FAMILIES_1D = ("ornstein_uhlenbeck", "heston", "hybrid_ou_bs")
FAMILIES_ND = ("black_scholes_nd", "ornstein_uhlenbeck_nd")
FAMILY_EPOCHS = 20           # epochs of each family's default recipe


def family_config(recipe: str, n_epochs: int, name: str,
                  process: str) -> dict:
    """A recipe's config for another family, named ``<name>_<process>``: a
    1-d family's through its own CLI with the recipe's flags (OU with
    --activation relu, which its CLI's 'identity' default resolves to);
    a d-dimensional family's from the Black-Scholes one, its data keys
    swapped for the family's parameters and its widths following dims
    (bench.py:177)."""
    name = f"{name}_{process}"
    if process in CLIS:
        extra = ("--activation", "relu") if process == "ornstein_uhlenbeck" \
            else ()
        return recipe_config(recipe, n_epochs, name, *extra, process=process)
    keep = ("n_train", "n_val", "obs_fraction", "cache_data", "T", "n_steps")
    cfg = recipe_config(recipe, n_epochs, name)
    cfg["data"] = {**{k: cfg["data"][k] for k in keep},
                   "process_type": process,
                   "obs_only": supports_obs_only(process),
                   **FAMILY_PARAMS[process]}
    del cfg["input_dim"], cfg["output_dim"]
    return cfg


def recipe_model(cfg: dict, dev: torch.device, seed: int = 0
                 ) -> NeuralJumpODE:
    """The model run_experiment builds for a config (the grid walk where
    the config's dt_ode_step asks for it, as the card resolves 'auto')."""
    d = int(cfg["data"].get("dims", 1))
    up = cfg["use_pallas"]
    return NeuralJumpODE(
        cfg.get("input_dim", d), cfg["hidden_dim"], cfg.get("output_dim", d),
        num_moments=2, shared_network=cfg["shared_network"],
        dt_ode_step=cfg["dt_ode_step"],
        grid_walk=cfg["dt_ode_step"] is not None,
        use_pallas=up if up in ("auto", "step", True) else False, device=dev,
        generator=torch.Generator().manual_seed(seed))


def trained_model(res: dict, dev: torch.device) -> NeuralJumpODE:
    """The model a run_experiment call trained, from its checkpoint."""
    model = recipe_model(res["config"], dev)
    sd, _, _ = load_checkpoint(str(Path(res["save_path"]) / "model.ckpt"),
                               map_location=dev)
    model.load_state_dict(sd)
    return model


def family_val_mse(model: NeuralJumpODE, dev: torch.device, process: str,
                   n: int, obs_fraction: float) -> tuple:
    """bench.py:435-455 for any family: n fresh grid-simulated trajectories,
    the MSE of the before-jump mean and variance against the closed-form
    truths past slot 0 (hybrid: at the drawn switch times; Heston: the BS
    approximation with xi)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    p = FAMILY_PARAMS[process]
    vb = simulate_batch(n, process, obs_fraction, generator=gen, device=dev,
                        **p)
    mse = conditional_moment_mse(
        model, vb, process,
        use_batch_switch_times=vb.switch_times is not None, **p)
    return mse["mean"], mse["var"]


def profiled_recipe(cfg: dict, dev: torch.device, n: int) -> tuple:
    """torch.profiler over n epochs of Trainer.train of a recipe (the
    kernels run_experiment takes for it) after one epoch of warm-up:
    (host wall ms an epoch, device ms an epoch, the device's idle share,
    device launches an epoch, the profiled epochs in words)."""
    from torch.profiler import ProfilerActivity, profile
    model = recipe_model(cfg, dev, seed=1)
    trainer = Trainer(
        model, make_adam(model.parameters(), 1e-3, 5e-4),
        ignore_first_continuity=True, moment_weights=cfg["moment_weights"],
        use_train_kernel="auto" if cfg["use_pallas"] == "auto" else False)
    loaders = create_data_loaders(base_seed=1, device=dev, **cfg["data"])
    timed_epochs(trainer, *loaders, cfg, 1, cfg["batch_size"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_epochs(trainer, *loaders, cfg, n, cfg["batch_size"])
    cuda = torch.autograd.DeviceType.CUDA
    on_dev = [e for e in prof.events() if e.device_type == cuda]
    dev_s = sum(e.time_range.elapsed_us() for e in on_dev) / 1e6
    return (1e3 * wall / n, 1e3 * dev_s / n, 1.0 - dev_s / wall,
            len(on_dev) / n, f"{n} epoch{'s' * (n > 1)}")


def family_run(cfg: dict, tmp: Path, window: str, want: dict) -> tuple:
    """run_experiment of a config in its own launch window (the counts set
    to 0 just before, read just after): (result, seconds, the window's
    counts).  The losses must be finite."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_experiment(cfg, save_dir=str(tmp))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = expect_counts(window, want)
    hist = res["history"]
    if not all(math.isfinite(x) for x in hist["train_loss"] + hist["val_loss"]
               + hist["relative_loss"]):
        raise AssertionError(f"{window}: non-finite losses {hist}")
    return res, secs, got


def recipe_line(process: str, res: dict, secs: float, n_traj: int,
                got: dict, prof: tuple, mse: tuple) -> str:
    """One run's figures: run_experiment's seconds and trajectories/s, its
    losses and launches, the profiled epochs (wall, device, idle share,
    launches) and the val MSE."""
    hist = res["history"]
    E = len(hist["train_loss"])
    return (f"{process}: {E} epoch{'s' * (E > 1)} in {secs:.3f} s = "
            f"{E * n_traj / secs:.0f} traj/s (run_experiment), train loss "
            f"{hist['train_loss'][0]:.4f} -> {hist['train_loss'][-1]:.4f}, "
            f"val {hist['val_loss'][-1]:.4f}, relative loss "
            f"{hist['relative_loss'][-1]:.4f}; launches "
            f"{ {k: v for k, v in got.items() if v} }; profiled "
            f"(Trainer.train, {prof[4]} after one): {prof[0]:.2f} ms of wall "
            f"an epoch, {prof[1]:.2f} ms of device time, idle "
            f"{100 * prof[2]:.1f}%, {prof[3]:.0f} device launches an epoch; "
            f"val MSE mean {mse[0]:.3e} var {mse[1]:.3e}")


def families_default_phase(dev: torch.device, card: str, tmp: Path) -> dict:
    """Phase 30: the default recipe of OU, Heston and hybrid (hidden 32, two
    networks, batch 128, 1,000 fresh trajectories an epoch, obs fraction
    0.1, weights [1, 10]) through run_experiment for FAMILY_EPOCHS epochs
    each, every epoch one launch of rows 11-12 and no other kernel; then
    one epoch of identical data of the family through rows 11-12 and
    through the composed path from identical weights (phase 9's check).
    Returns {process: seconds an epoch}."""
    out, lines, errs = {}, [], []
    for process in FAMILIES_1D:
        cfg = family_config("default", FAMILY_EPOCHS, "default", process)
        res, secs, got = family_run(cfg, tmp, f"default {process}",
                                    {11: FAMILY_EPOCHS})
        mse = family_val_mse(trained_model(res, dev), dev, process, 200, 0.1)
        prof = profiled_recipe(cfg, dev, 2)
        model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                              generator=torch.Generator().manual_seed(5))
        errs.append(kernel_vs_composed(model, train_data(
            dev, 1024, TRAIN_BS, 11, n_valid=1000, process=process)))
        lines.append(recipe_line(process, res, secs, 1000, got, prof, mse))
        out[process] = secs / FAMILY_EPOCHS
    print(f"families, default recipe on {card} (rows 11-12; hidden 32, two "
          f"networks, batch 128, 1,000 fresh trajectories an epoch, obs-only "
          f"where exact, Heston on the grid): " + "; ".join(lines)
          + f"; kernel vs composed, one epoch of each family's data from "
          f"identical weights, per-step losses and params at rtol {RTOL} / "
          f"atol {ATOL}: max abs err "
          + ", ".join(f"{e:.3e}" for e in errs), flush=True)
    return out


def families_production_phase(dev: torch.device, card: str,
                              tmp: Path) -> dict:
    """Phase 31: the production recipe of OU, Heston and hybrid
    (scripts/run_{ou,heston,hybrid}.sh: hidden 50, shared, dt_ode_step
    0.01, batch 256, 10,000 fresh trajectories an epoch, validation 2,000,
    weights [1, 15]) through run_experiment for 3 epochs each: row 13 once
    an epoch, row 1 in validation and the relative loss, no other kernel.
    OU and hybrid sample obs-only, Heston on the grid.  Returns {process:
    seconds an epoch}."""
    out, lines = {}, []
    for process in FAMILIES_1D:
        cfg = family_config("production", 3, "production", process)
        res, secs, got = family_run(cfg, tmp, f"production {process}",
                                    {13: 3, 1: None})
        mse = family_val_mse(trained_model(res, dev), dev, process, PROD_VAL,
                             0.1)
        prof = profiled_recipe(cfg, dev, 2)
        lines.append(recipe_line(process, res, secs, PROD_TRAIN, got, prof,
                                 mse))
        out[process] = secs / 3
    print(f"families, production recipe on {card} (row 13, row 1 in "
          f"validation; hidden {PROD_H}, shared, dt {PROD_DT}, batch "
          f"{PROD_BS}, {PROD_TRAIN:,} fresh trajectories an epoch, "
          f"{PROD_VAL:,} validation): " + "; ".join(lines), flush=True)
    return out


def heston_datagen_phase(card: str, dev: torch.device, epoch_s: dict) -> None:
    """Heston's data generation an epoch (the 100-step variance recurrence
    on the card, then the observations), host clock around synchronized
    calls, median of 5 after one, beside the epoch it feeds."""
    gen = torch.Generator(device=dev).manual_seed(3)
    parts = []
    for recipe, n in (("default", 1000), ("production", PROD_TRAIN)):
        def one():
            simulate_batch(n, "heston", 0.1, generator=gen, device=dev,
                           **FAMILY_PARAMS["heston"])
            torch.cuda.synchronize()
        one()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            one()
            ts.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(ts)
        share = ms / (1e3 * epoch_s[recipe])
        parts.append(f"{recipe} ({n:,} grid paths) {ms:.3f} ms an epoch, "
                     f"{100 * share:.1f}% of its run_experiment epoch "
                     f"({1e3 * epoch_s[recipe]:.2f} ms)")
    print(f"Heston data generation on {card}: " + "; ".join(parts),
          flush=True)


def step_nd2_phase(dev: torch.device, card: str) -> dict:
    """Phase 32: rows 9-10 at d_x = d_y = 2 against their plain versions
    (the scaled d=2 shape, H 256, N 2, two networks, L 1, relu/identity at
    4,096 rows, and tanh/tanh at 1,696), at phase 17's limits: the forward
    at rtol 1e-4 / atol 1e-5 and STEP_FWD_NORM of its norm, every dW plane
    and dV row within step_grad_rtol of its norm, the 1xTF32 control
    failing both, two backward calls bitwise equal.  Then CUDA-event times
    at d_x 2 beside d_x 1 in turns, and the bound at d_x 2.  Returns each
    kernel's (ms, plain ms, bound ms, bound_by) at d_x 2 and the errors."""
    gen = torch.Generator().manual_seed(23)
    f_err = b_err = fs_w = bs_w = 0.0
    cf_min = cb_min = math.inf
    cases = {}
    for act, scale, rows in (("relu", "identity", SCALED_BS),
                             ("tanh", "tanh", 1696)):
        c = step_case(gen, SCALED_H, 2, False, 1, act, scale, rows, dev, d=2)
        cases[act] = c
        where = f"d_x 2, H {SCALED_H}, N 2, {act}/{scale}, rows {rows}"
        grad_rtol = step_grad_rtol(act)
        with torch.no_grad():
            y_k = step_fwd(c, act, scale, True)
            y_p = step_fwd(c, act, scale, False)
            g_k = step_bwd(c, act, scale, True)
            g_k2 = step_bwd(c, act, scale, True)
            g_p = step_bwd(c, act, scale, False)
        torch.cuda.synchronize()
        f_err = max(f_err, assert_close(y_k, y_p, f"row 9 at {where}"))
        share = step_fwd_share(y_k, y_p)
        if not share <= 1.0:
            raise AssertionError(f"row 9 at {where}: share {share:.3f} of "
                                 "the forward limits")
        fs_w = max(fs_w, share)
        bs_w = max(bs_w, step_bwd_share(g_k, g_p, grad_rtol))
        for a, a2, b, what in zip(g_k, g_k2, g_p, ("dW", "dV")):
            if not torch.equal(a, a2):
                raise AssertionError(f"two row 10 calls differ in {what} at "
                                     f"{where}")
            for i in range(a.shape[0]):
                for j in range(a.shape[1]):
                    b_err = max(b_err, assert_close_norm(
                        a[i, j], b[i, j], f"row 10 {what}[{i}, {j}] at "
                        f"{where}", grad_rtol))
        y_c, g_c = step_plain_tf32(c, act, scale)
        cf, cb = step_fwd_share(y_c, y_p), step_bwd_share(g_c, g_p, grad_rtol)
        if not (cf > 1.0 and cb > 1.0):
            raise AssertionError(f"the 1xTF32 control passes at {where} "
                                 f"(forward {cf:.3f}, backward {cb:.3f})")
        cf_min, cb_min = min(cf_min, cf), min(cb_min, cb)
    c2 = cases["relu"]
    c1 = step_case(gen, SCALED_H, 2, False, 1, "relu", "identity", SCALED_BS,
                   dev)
    t = {}
    with torch.no_grad():
        for d, c in ((1, c1), (2, c2), (2, c2), (1, c1)):
            for b in (False, True):
                fn = step_bwd if b else step_fwd
                t.setdefault((d, b), []).append(time_ms(
                    lambda: fn(c, "relu", "identity", True), warmup=3,
                    reps=20))
        plain = {b: time_ms(lambda: (step_bwd if b else step_fwd)(
            c2, "relu", "identity", False), warmup=1, reps=5)
            for b in (False, True)}
    lo = c2["lo"]
    flops = step_flops(SCALED_H, 2, lo, SCALED_BS)
    io = 4 * (c2["W"].numel() + c2["V"].numel() + c2["times"].numel()
              + c2["values"].numel())
    f_bound = bound_of(3 * flops, io + 4 * c2["gy"].numel(), PEAK_TF32_FLOPS)
    b_bound = bound_of(9 * flops, io + 4 * (c2["gy"].numel()
                                            + c2["W"].numel()
                                            + c2["V"].numel()),
                       PEAK_TF32_FLOPS)
    med = {k: statistics.median(v) for k, v in t.items()}
    print(f"fused-step kernels at d_x 2 vs plain: 2 cases (H {SCALED_H}, N 2, "
          f"two networks, L 1; relu/identity at {SCALED_BS} rows, tanh/tanh "
          f"at 1,696): forward max abs err {f_err:.3e}, worst share "
          f"{fs_w:.3f} (rtol {RTOL} / atol {ATOL}, {STEP_FWD_NORM} of the "
          f"norm); backward max abs err {b_err:.3e}, worst share {bs_w:.3f} "
          f"({STEP_GRAD_RTOL} of each norm, {GRAD_RTOL} with relu); the "
          f"1xTF32 control fails both, smallest shares {cf_min:.3f} / "
          f"{cb_min:.3f}; two backward calls bitwise equal; plan "
          f"{step_plan(c2)}", flush=True)
    print(f"fused-step kernels on {card} at {SCALED_BS} rows, H {SCALED_H}, "
          f"N 2, relu/identity, in turns (d_x 1, 2, 2, 1): row 9 at d_x 2 "
          f"{', '.join(f'{x:.4f}' for x in t[2, False])} ms, at d_x 1 "
          f"{', '.join(f'{x:.4f}' for x in t[1, False])} ms (plain at d_x 2 "
          f"{plain[False]:.4f} ms; bound {f_bound[0]:.4f} ms {f_bound[1]}); "
          f"row 10 at d_x 2 {', '.join(f'{x:.4f}' for x in t[2, True])} ms, "
          f"at d_x 1 {', '.join(f'{x:.4f}' for x in t[1, True])} ms (plain "
          f"{plain[True]:.4f} ms; bound {b_bound[0]:.4f} ms {b_bound[1]})",
          flush=True)
    return {"fused_step_fwd": (med[2, False], plain[False], *f_bound),
            "fused_step_bwd": (med[2, True], plain[True], *b_bound),
            "errs": (f_err, b_err)}


def scaled_nd_phase(dev: torch.device, card: str, tmp: Path) -> dict:
    """Phase 33: the scaled d=2 recipe (bench.py --process black_scholes_nd
    --dims 2 --scaled: hidden 256, two networks, batch 4,096, 100,000 fresh
    obs-only trajectories an epoch, obs fraction 0.02, use_pallas 'step'),
    then the same with ornstein_uhlenbeck_nd, one epoch each through
    run_experiment: row 10 once a step, row 9 once a step, once for the
    validation and once for the relative loss, no other kernel.  Returns
    the launches of the first window."""
    lines, first = [], None
    for process in FAMILIES_ND:
        cfg = family_config("scaled", 1, "scaled", process)
        res, secs, got = family_run(
            cfg, tmp, f"scaled {process}",
            {9: SCALED_STEPS + 2, 10: SCALED_STEPS})
        first = first or got
        mse = family_val_mse(trained_model(res, dev), dev, process,
                             SCALED_VAL, 0.02)
        prof = profiled_recipe(cfg, dev, 1)
        lines.append(recipe_line(process, res, secs, SCALED_TRAIN, got, prof,
                                 mse))
    print(f"scaled d=2 recipes on {card} (rows 9-10 at d_x = d_y = 2; hidden "
          f"{SCALED_H}, two networks, batch {SCALED_BS}, {SCALED_TRAIN:,} "
          f"fresh trajectories an epoch, validation {SCALED_VAL:,}): "
          + "; ".join(lines), flush=True)
    return first


def serving_nd_phase(dev: torch.device, card: str) -> dict:
    """Phase 34: a production-d=2 model (hidden 50, shared, two moments,
    dt_ode_step 0.01, d_x = d_y = 2) serves predict_at at the batch shape,
    1,000 black_scholes_nd streams x 21 queries, in its own launch window
    (row 1, nothing else); then row 1 at d_x 2 against its plain version
    on the kernel's own arguments (t_L bitwise, h at rtol 1e-4 / atol
    1e-5), predict_at against the same model on the CPU, and CUDA-event
    times of row 1 at d_x 2 beside d_x 1 in turns.  Returns row 1's
    (launches, max abs err, ms, plain ms, bound ms, bound_by) at d_x 2."""
    model = NeuralJumpODE(2, 50, 2, num_moments=2, shared_network=True,
                          dt_ode_step=DT, t_max=1.0, device=dev,
                          generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    b = simulate_batch(1000, "black_scholes_nd", 0.1, generator=gen,
                       **FAMILY_PARAMS["black_scholes_nd"])
    times = [t[3:] if i % 4 == 0 else t for i, t in enumerate(b.times)]
    values = [v[3:] if i % 4 == 0 else v for i, v in enumerate(b.values)]
    obs_t, obs_v, mask = pad_ragged(times, values, device=dev)
    query = torch.sort(torch.rand(1000, 21, generator=gen),
                       dim=1).values.to(dev)
    reset_counts()
    out = model.predict_at(obs_t, obs_v, query, mask)
    torch.cuda.synchronize()
    got = expect_counts("serving d_x 2 (predict_at)", {1: None})
    raw = out["raw"]
    if raw.shape != (1000, 21, 2, 2) or not torch.isfinite(raw).all():
        raise AssertionError(f"predict_at at d_x 2: shape "
                             f"{tuple(raw.shape)}, or non-finite values")
    first = torch.where(mask, obs_t, torch.inf)[:, :1]
    if (raw[query < first] != 0).any():
        raise AssertionError("d_x 2: a query before the first observation "
                             "does not read 0")
    args = gap_rows(model, obs_t, obs_v, query, mask)
    err = gap_pair_close(args, "row 1 at d_x 2, the predict_at shape")
    ref = copy.deepcopy(model).to("cpu").predict_at(
        obs_t.cpu(), obs_v.cpu(), query.cpu(), mask.cpu())
    pa_err = assert_close(raw, ref["raw"], "predict_at at d_x 2 vs plain "
                          "(CPU)")
    args1 = gap_rows(production_model(dev), *batch_request(dev))
    t = {1: [], 2: []}
    with torch.no_grad():
        for d, a in ((1, args1), (2, args), (2, args), (1, args1)):
            t[d].append(time_ms(lambda: gap_scan.gap_substeps(*a)))
        p_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*args),
                       warmup=1, reps=5)
    pa_ms = time_ms(lambda: model.predict_at(obs_t, obs_v, query, mask))
    bound, by = gap_bound(args)
    print(f"serving d_x 2 on {card}: predict_at of a production-d=2 model "
          f"(hidden 50, shared, dt {DT}), 1,000 black_scholes_nd streams x "
          f"21 queries: launches {got[1]} of row 1 and no other kernel; "
          f"row 1 vs plain max abs err {err:.3e} (t_L bitwise); predict_at "
          f"vs the CPU model max abs err {pa_err:.3e}; row 1 in turns at "
          f"d_x 2 {', '.join(f'{x:.4f}' for x in t[2])} ms, at d_x 1 "
          f"{', '.join(f'{x:.4f}' for x in t[1])} ms (plain at d_x 2 "
          f"{p_ms:.4f} ms; bound {bound:.4f} ms {by}); predict_at "
          f"{pa_ms:.4f} ms = {21000 / (pa_ms / 1e3):.0f} queries/s",
          flush=True)
    return {"launches": got[1], "max_abs_err": err,
            "ms": statistics.median(t[2]), "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by}


# ---------------------------------- the inference surface and the CLIs

GRID_PATHS, GRID_STEPS = 1000, 100     # phases 35-36: 1,000 paths, 101 points
SAMPLE_CPU_PATHS = 250   # paths of phase 36's CPU twin (each path's rollout
#                          reads only its own row; the plain gap loop takes
#                          its 100 masked substeps a step on the host)
# phase 36's normwise limit on whole stochastic paths, card against the CPU
# twin on the card's normals: see sampling_phase
SAMPLE_PATH_NORM = 1e-6


def profiled_call(fn) -> tuple:
    """One call of fn under torch.profiler after one of warm-up: (host wall
    ms, device ms, the device's idle share, device launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    on_dev = [e for e in prof.events() if e.device_type == cuda]
    dev_s = sum(e.time_range.elapsed_us() for e in on_dev) / 1e6
    return 1e3 * wall, 1e3 * dev_s, 1.0 - dev_s / wall, len(on_dev)


def grid_request(dev: torch.device) -> tuple:
    """GRID_PATHS Black-Scholes grid paths (mu 0.1, sigma 0.5, x0 1, T 1,
    GRID_STEPS steps) observed at obs_fraction 0.1 of the grid points (0 and
    T included); every 4th path loses its observations before t = 0.3, so
    it reads zeros until its first, and every 3rd those after t = 0.8, so
    it extrapolates.  (times (G,), mask (B, G), values (B, G, 1))."""
    gen = torch.Generator(device=dev).manual_seed(4)
    times, X = bs_paths(GRID_PATHS, 0.1, 0.5, 1.0, GRID_STEPS, 1.0,
                        generator=gen)
    idx = sample_obs_indices(GRID_PATHS, GRID_STEPS + 1, 0.1, generator=gen)
    mask = torch.zeros(GRID_PATHS, GRID_STEPS + 1, dtype=torch.bool,
                       device=dev).scatter_(1, idx, True)
    mask[::4, :30] = False
    mask[::3, 81:] = False
    return times, mask, X[..., None]


def grid_rollout_phase(dev: torch.device, card: str) -> dict:
    """Phase 35: predict_on_grid of the production model (hidden 50,
    shared, two moments, dt_ode_step 0.01) on grid_request's 1,000 paths x
    101 points, in its own launch window (no kernel: the rollout is a loop
    of _euler substeps, composed on the card), held against the same
    weights on the CPU; zeros before a path's first observation.  The same
    call under use_pallas=True takes every substep through row 6: G x
    n_sub launches and nothing else, agreeing with the unforced call at
    phase 4's limits.  A separate-network (K_h 2) call against the CPU
    too.  Times: CUDA events a call, grid points/s, and one profiled
    call's idle share.  Returns row 6's launches in the forced window."""
    times, mask, values = grid_request(dev)
    G = times.shape[0]
    cpu_args = (times.cpu(), mask.cpu(), values.cpu())
    errs, launches = {}, {}
    for name, shared in (("shared", True), ("separate", False)):
        model = production_model(dev, shared=shared)
        reset_counts()
        out = model.predict_on_grid(times, mask, values)
        torch.cuda.synchronize()
        expect_counts(f"predict_on_grid ({name})", {})
        raw = out["raw"]
        if raw.shape != (GRID_PATHS, G, 1, 2) or not torch.isfinite(
                raw).all():
            raise AssertionError(f"predict_on_grid ({name}): shape "
                                 f"{tuple(raw.shape)}, or non-finite values")
        first = mask.to(torch.int8).argmax(dim=1)
        before = (torch.arange(G, device=dev)[None] < first[:, None])
        if not before.any() or (raw[before] != 0).any() or (
                raw[~before] == 0).all():
            raise AssertionError(f"predict_on_grid ({name}): the grid "
                                 "points before a path's first observation "
                                 "must exist and read exactly 0")
        ref = copy.deepcopy(model).to("cpu").predict_on_grid(*cpu_args)
        errs[name] = assert_close(raw, ref["raw"], f"predict_on_grid "
                                  f"({name}) vs the CPU model")
    model = production_model(dev)
    forced = production_model(dev, use_pallas=True)
    n_sub = forced._grid_substeps(times)
    reset_counts()
    out_f = forced.predict_on_grid(times, mask, values)
    torch.cuda.synchronize()
    launches = expect_counts("forced predict_on_grid (row 6)",
                             {6: G * n_sub})
    unforced = model.predict_on_grid(times, mask, values)
    errs["forced"] = assert_close(out_f["raw"], unforced["raw"],
                                  "forced vs unforced predict_on_grid")
    t = {"unforced": [], "forced": []}
    for arm in ("unforced", "forced", "forced", "unforced"):
        m = model if arm == "unforced" else forced
        t[arm].append(time_ms(lambda: m.predict_on_grid(times, mask, values),
                              warmup=2, reps=10))
    prof = profiled_call(lambda: model.predict_on_grid(times, mask, values))
    ms = statistics.median(t["unforced"])
    print(f"grid rollout on {card}: predict_on_grid of the production model "
          f"(hidden 50, shared, dt {DT}; n_sub {n_sub}) on {GRID_PATHS:,} BS "
          f"paths x {G} grid points: no kernel launched; vs the CPU model "
          f"max abs err {errs['shared']:.3e} (separate networks, K_h 2: "
          f"{errs['separate']:.3e}); forced (use_pallas True): row 6 "
          f"{launches[6]} launches = G x n_sub, nothing else, vs unforced "
          f"max abs err {errs['forced']:.3e}; times in turns (CUDA events, "
          f"median of 10) unforced {', '.join(f'{x:.3f}' for x in t['unforced'])} "
          f"ms, forced {', '.join(f'{x:.3f}' for x in t['forced'])} ms; "
          f"{GRID_PATHS * G / (ms / 1e3):.0f} grid points/s unforced; one "
          f"profiled unforced call {prof[0]:.3f} ms of wall, {prof[1]:.3f} ms "
          f"device, idle {100 * prof[2]:.1f}%, {prof[3]} device launches",
          flush=True)
    return {6: launches[6]}


def sample_prefix(dev: torch.device) -> tuple:
    """A 10-observation prefix on [0, 0.45] (every 5th point of one BS
    path) and the 101-point grid on [0.5, 1.5] it conditions."""
    times, X = bs_paths(1, 0.1, 0.5, 1.0, GRID_STEPS, 1.0,
                        generator=torch.Generator(device=dev).manual_seed(6))
    obs_t, obs_v = times[:50:5], X[0, :50:5, None]
    grid = torch.linspace(0.5, 1.5, GRID_STEPS + 1, device=dev)
    return grid, obs_t, obs_v


def sampling_phase(dev: torch.device, card: str) -> dict:
    """Phase 36: sample_paths of the production model, 1,000 paths on a
    101-point grid, each law (gaussian, lognormal, mean), from x0 1.0 on
    [0, 1] and from a 10-observation prefix (sample_prefix), each call in
    its own launch window: row 1 G - 1 times (G with the prefix), nothing
    else.  sample_paths_from_normals on a CPU twin of the model, given the
    card's normals (the first SAMPLE_CPU_PATHS paths), must give the whole
    mean path and the first stochastic step at phase 4's limits, and the
    whole stochastic paths within SAMPLE_PATH_NORM of their norm.

    Why that bound holds: each step's draw x' = m(x) + s(x) z (lognormal:
    its exp form) adds the card's rounding difference of one step (the
    first stochastic step's, at most 3e-8 on an H100, phase 4's order) and
    carries the previous difference through the step's map, whose slope in
    x is this model's.  Measured (NVIDIA H100 80GB HBM3, 700 W): the
    largest difference a step stays flat at 4e-8-6e-8 from step 10 to step
    100, for every law and start (the map does not amplify it), and whole
    paths differ by 7e-8-1.1e-7 of their norm, about one f32 rounding of
    values near 1.  A difference that grows from step to step (a wrong
    carry, a draw from the wrong normal) would pass the limit of 1e-6 of
    the norm within a few steps; one step's rounding, carried flat, stays
    ten times inside it.  Two calls with generators of one seed are bitwise
    equal.  Times: CUDA events a call, samples/s.  Returns row 1's launches
    by (law, start)."""
    model = production_model(dev)
    cpu = copy.deepcopy(model).to("cpu")
    G = GRID_STEPS + 1
    grid0 = torch.linspace(0.0, 1.0, G, device=dev)
    grid_p, obs_t, obs_v = sample_prefix(dev)
    n = SAMPLE_CPU_PATHS
    lines, out = [], {}
    for law in STEP_LAWS:
        for start in ("x0", "prefix"):
            prefix = start == "prefix"
            kw = (dict(grid_times=grid_p, x0=None, obs_times=obs_t,
                       obs_values=obs_v) if prefix
                  else dict(grid_times=grid0, x0=1.0))
            window = f"sample_paths ({law}, from {start})"

            def call(seed=11):
                return sample_paths(
                    model, torch.Generator(device=dev).manual_seed(seed),
                    GRID_PATHS, law=law, **kw)
            reset_counts()
            s = call()
            torch.cuda.synchronize()
            got = expect_counts(window, {1: G if prefix else G - 1})
            if s.shape != (GRID_PATHS, G, 1) or not torch.isfinite(s).all():
                raise AssertionError(f"{window}: shape {tuple(s.shape)}, or "
                                     "non-finite samples")
            if not torch.equal(s, call()):
                raise AssertionError(f"{window}: two calls with generators "
                                     "of one seed differ")
            normals = None
            if law != "mean":
                normals = torch.randn(
                    G, GRID_PATHS, 1, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(11))
                normals = normals[:, :n].cpu()
            cpu_kw = {k: v.cpu() if torch.is_tensor(v) else v
                      for k, v in kw.items()}
            ref = sample_paths_from_normals(cpu, normals, n, law=law,
                                            **cpu_kw)
            ours = s[:n].cpu()
            k = G if law == "mean" else (1 if prefix else 2)
            err = assert_close(ours[:, :k], ref[:, :k],
                               f"{window}: the first {k} steps vs the CPU "
                               f"twin")
            step_err = (ours - ref).abs().amax(dim=(0, 2))
            norm = float((ours - ref).norm() / ref.norm())
            if norm > SAMPLE_PATH_NORM:
                raise AssertionError(
                    f"{window}: whole paths {norm:.3e} of their norm from "
                    f"the CPU twin, beyond {SAMPLE_PATH_NORM}; largest "
                    f"difference by step {step_err.tolist()}")
            ms = time_ms(call, warmup=1, reps=5)
            out[(law, start)] = got[1]
            lines.append(
                f"{law} from {start}: row 1 {got[1]} launches; first {k} "
                f"step{'s' * (k > 1)} max abs err {err:.3e}; whole paths "
                f"{norm:.3e} of their norm, largest difference at steps "
                f"1/10/50/100 {step_err[1]:.2e}/{step_err[10]:.2e}/"
                f"{step_err[50]:.2e}/{step_err[100]:.2e}; {ms:.3f} ms a call "
                f"= {GRID_PATHS * G / (ms / 1e3):.0f} samples/s")
    print(f"generative sampling on {card}: sample_paths of the production "
          f"model, {GRID_PATHS:,} paths x {G} grid points (the CPU twin on "
          f"the first {n} with the card's normals; two calls of one seed "
          f"bitwise equal): " + "; ".join(lines), flush=True)
    return out


def cli_run(module, argv: list, window: str, want: dict) -> tuple:
    """A CLI's main(argv) in process, its output kept, in its own launch
    window: (result, the window's counts, its output)."""
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        res = module.main(argv)
    torch.cuda.synchronize()
    return res, expect_counts(window, want), buf.getvalue()


def cli_phase(dev: torch.device, card: str, tmp: Path) -> dict:
    """Phase 37: the experiment CLIs in process (``main(argv)``) with
    --device cuda --no-plots, from a temporary directory (runs/ under it),
    each run in its own launch window.  The default recipe for 3 epochs:
    rows 11-12 once an epoch, nothing else (its validation launches no
    kernel), the saved config.json equal to build_config's dict; a second
    call to 4 epochs resumes at epoch 3 (one launch).  The production flags
    of scripts/run_black_scholes.sh for 2 epochs: row 13 once an epoch, row
    1 in validation.  OU, Heston and hybrid at their defaults, 2 epochs
    each: rows 11-12 once an epoch (phase 30's check).  One run with
    --profile-dir writes a non-empty trace.  Where matplotlib imports, one
    run without --no-plots writes the three PNGs; where it does not, that
    run fails on the import after training.  Returns the launches by
    window."""
    flags = ["--device", "cuda", "--no-plots"]
    out, lines = {}, []
    with contextlib.chdir(tmp):
        runs = tmp / "runs"
        argv = ["--n-epochs", "3", *flags]
        t0 = time.perf_counter()
        res, got, _ = cli_run(ebs, argv, "CLI default", {11: 3})
        secs = time.perf_counter() - t0
        saved = json.loads((runs / ebs.NAME / "config.json").read_text())
        want = json.loads(json.dumps(ebs.configure(ebs.parse_args(argv))[0]))
        if saved != want:
            raise AssertionError(f"CLI default: config.json {saved} is not "
                                 f"build_config's {want}")
        first = res["history"]["train_loss"]
        res4, got4, text = cli_run(ebs, ["--n-epochs", "4", *flags],
                                   "CLI default resumed", {11: 1})
        hist4 = res4["history"]["train_loss"]
        if len(hist4) != 4 or hist4[:3] != first or "(resumed)" not in text:
            raise AssertionError(f"CLI default: the rerun to 4 epochs did "
                                 f"not resume at epoch 3: {hist4}")
        out["default"] = got[11]
        lines.append(f"default 3 epochs {secs:.2f} s (train loss "
                     f"{first[0]:.4f} -> {first[-1]:.4f}), row 11 {got[11]} "
                     f"launches, config.json = build_config's dict, resumed "
                     f"to 4 with {got4[11]} launch")
        t0 = time.perf_counter()
        res, got, _ = cli_run(
            ebs, [*RECIPE_FLAGS["production"], "--n-epochs", "2",
                  "--experiment-name", "cli_production", *flags],
            "CLI production", {13: 2, 1: None})
        out["production"] = got
        lines.append(f"production 2 epochs {time.perf_counter() - t0:.2f} s "
                     f"(val {res['history']['val_loss'][-1]:.4f}), row 13 "
                     f"{got[13]}, row 1 {got[1]} in validation")
        for module in (eou, ehe, ehy):
            t0 = time.perf_counter()
            res, got, _ = cli_run(module, ["--n-epochs", "2", *flags],
                                  f"CLI {module.NAME}", {11: 2})
            out[module.NAME] = got[11]
            lines.append(f"{module.NAME} defaults 2 epochs "
                         f"{time.perf_counter() - t0:.2f} s, row 11 "
                         f"{got[11]}")
        prof_dir = tmp / "profile"
        _, got, _ = cli_run(ebs, ["--n-epochs", "1", "--experiment-name",
                                  "cli_profiled", "--profile-dir",
                                  str(prof_dir), *flags],
                            "CLI --profile-dir", {11: 1})
        traces = list(prof_dir.glob("trace_*.json"))
        if len(traces) != 1 or traces[0].stat().st_size == 0:
            raise AssertionError(f"--profile-dir wrote {traces}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            raise AssertionError("the --profile-dir trace holds no kernel")
        lines.append(f"--profile-dir trace {traces[0].stat().st_size:,} "
                     f"bytes, {len(events)} events, {len(kernels)} kernels")
        plot_argv = ["--n-epochs", "1", "--experiment-name", "cli_plots",
                     "--device", "cuda"]
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ImportError:
            has_mpl = False
        if has_mpl:
            cli_run(ebs, plot_argv, "CLI with plots", {11: 1})
            pngs = sorted(p.name for p in (runs / "cli_plots").glob("*.png"))
            if pngs != ["relative_loss.png", "trajectory_comparison.png",
                        "training_history.png"]:
                raise AssertionError(f"the plots run wrote {pngs}")
            lines.append("matplotlib imports here: the plots run wrote "
                         + ", ".join(pngs))
        else:
            try:
                cli_run(ebs, plot_argv, "CLI with plots", {11: 1})
            except ImportError as e:
                if e.name != "matplotlib":
                    raise
            else:
                raise AssertionError("plots asked for without matplotlib "
                                     "were skipped")
            if not (runs / "cli_plots" / "model.ckpt").is_file():
                raise AssertionError("the plots run did not train first")
            lines.append("no matplotlib here: the run asking for plots "
                         "trained, then failed on the import")
    print(f"experiment CLIs on {card} (python -m njode_tpu_torch.experiments"
          f".experiment_*, main in process, --device cuda --no-plots): "
          + "; ".join(lines), flush=True)
    return out


def phase_time(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s", flush=True)
    return now


def main() -> None:
    t0 = time.perf_counter()
    dev, card = device_phase()
    build_s = build_phase()
    t = phase_time("build", t0)
    max_err = kernel_phase(dev)

    model = production_model(dev)
    request = batch_request(dev)
    gap_scan.LAUNCHES = 0
    batch_phase(dev, model, request)
    streaming_phase(dev, model)
    launches = gap_scan.LAUNCHES

    k_ms, p_ms = timing_phase(dev, card, model, request)
    g_bound, g_by = gap_bound(gap_rows(model, *request))
    t = phase_time("serving", t)

    print(f"build: train_run.cu in {build_s:.2f} s (with the other sources, "
          f"in parallel); ptxas by instance <columns a lane, all in shared "
          f"memory, bf16> (default recipe: <1, 1, 0>): "
          f"{ptxas_instances('train_run')}", flush=True)
    t_err = train_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tk.LAUNCHES = 0
        training_path_phase(dev, Path(tmp))
        t_launches = tk.LAUNCHES
        t_err = max(t_err, kernel_vs_composed_phase(dev))
        tk_ms, tp_ms, t_bound, t_by = training_times_phase(dev, card,
                                                           Path(tmp))
    t = phase_time("default training", t)

    for name in ("walk_scan", "walk_train"):
        print(f"build: {name}.cu in {build_s:.2f} s (with the other sources, "
              f"in parallel); ptxas: {ptxas_summary(name)}", flush=True)
    print(f"ptxas: walk_scan.cu by kernel (forward <columns a lane, "
          f"relu/identity compiled in, residuals kept>, backward <columns a "
          f"lane, relu/identity compiled in>; none may spill): "
          f"{ptxas_check('walk_scan', WALK_KERNELS)}", flush=True)
    print(f"ptxas: walk_train.cu by instance <columns a lane, stages, "
          f"relu/identity compiled in, bf16> (production: <2, 1, 1, 0>): "
          f"{ptxas_instances('walk_train')}", flush=True)
    wf_err, wb_err = walk_kernel_phase(dev)
    wt_err = walk_train_phase(dev)
    t = phase_time("walk kernels vs plain", t)
    # each path's launch window: the counts set to 0 just before it and
    # read just after
    with tempfile.TemporaryDirectory() as tmp:
        walk_scan.LAUNCHES_FWD = walk_scan.LAUNCHES_BWD = wt.LAUNCHES = 0
        gap_scan.LAUNCHES = 0
        production_path_phase(dev, Path(tmp))
        prod_launches = wt.LAUNCHES
    walk_scan.LAUNCHES_FWD = walk_scan.LAUNCHES_BWD = wt.LAUNCHES = 0
    composed_grid_walk_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        separate = separate_grid_walk_path_phase(dev, Path(tmp))
    wt_err = max(wt_err, walk_twin_vs_composed_phase(dev))
    t = phase_time("production training path", t)
    times = {"walk_train": production_times_phase(dev, card)}
    t = phase_time("production times", t)
    times.update(walk_times_phase(dev, card))
    t = phase_time("walk kernel times", t)

    step_build_phase(build_s)
    sf_err, sb_err, _ = step_kernel_phase(dev)
    t = phase_time("fused-step kernels vs plain", t)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        scaled_path_phase(dev, Path(tmp))
        step_launches = (fs.LAUNCHES_FWD, fs.LAUNCHES_BWD)
    step_vs_composed_phase(dev)
    t = phase_time("scaled training path", t)
    times.update(scaled_times_phase(dev, card))
    t = phase_time("scaled times", t)

    for name in ("gap_train", "fused_cell"):
        print(f"build: {name}.cu in {build_s:.2f} s (with the other sources, "
              f"in parallel); ptxas: {ptxas_summary(name)}", flush=True)
    print(f"ptxas: gap_train.cu by kernel (forward <columns a lane, "
          f"relu/identity compiled in>, backward <columns a "
          f"lane, relu/identity compiled in>; neither may spill): "
          f"{ptxas_check('gap_train', GAP_TRAIN_KERNELS)}; fused_cell.cu by "
          f"kernel <columns a lane, weights in registers, relu compiled in>: "
          f"{cell_ptxas_check()}", flush=True)
    gap_errs = gap_train_kernel_phase(dev)
    cell_err = fused_cell_kernel_phase(dev)
    t = phase_time("forced kernels vs plain", t)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        forced = forced_production_path_phase(dev, Path(tmp))
        reset_counts()
        forced.update({6: forced_default_path_phase(dev, Path(tmp))[6]})
        reset_counts()
        full = full_residual_window_phase(dev, Path(tmp))
        forced.update({2: full[2], 4: full[4]})
    for name, cfg, kw, mw, bs in (
            ("forced production", forced_production_config(1, "ab"),
             PROD_MODEL_KW, PROD_MW, PROD_BS),
            ("forced production at dt_ode_step 0.1",
             forced_production_config(1, "ab", dt=0.1),
             {**PROD_MODEL_KW, "dt_ode_step": 0.1}, PROD_MW, PROD_BS),
            ("forced default", forced_default_config(1, "ab"),
             DEFAULT_MODEL_KW, (1.0, 10.0), TRAIN_BS)):
        forced_vs_composed_phase(dev, cfg, kw, mw, bs, name)
    t = phase_time("forced training paths", t)
    forced_times, main_errs = forced_times_phase(dev, card)
    for mode, e in main_errs.items():
        gap_errs[mode] = [max(a, b) for a, b in zip(gap_errs[mode], e)]
    t = phase_time("forced times", t)

    bf16_bitwise_check(dev)
    bf_f_err, bf_b_err, _ = step_kernel_phase(dev, BF16)
    t = phase_time("bf16 fused-step kernels vs plain", t)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        bf16_launches = scaled_bf16_path_phase(dev, Path(tmp))
    bf16_vs_plain_epoch_phase(dev)
    t = phase_time("bf16 scaled training path", t)
    times.update(bf16_times_phase(dev, card))
    t = phase_time("bf16 times", t)

    mxu_errs = mxu_bf16_kernel_phase(dev)
    t = phase_time("bf16 whole-run kernels vs plain", t)
    with tempfile.TemporaryDirectory() as tmp:
        mxu_launches = mxu_bf16_path_phase(dev, Path(tmp))
    t = phase_time("bf16 whole-run training paths", t)
    times.update(mxu_bf16_times_phase(dev, card))
    t = phase_time("bf16 whole-run times", t)

    with tempfile.TemporaryDirectory() as tmp:
        epoch_s = {"default": families_default_phase(dev, card, Path(tmp))}
        t = phase_time("families, default recipes (rows 11-12)", t)
        epoch_s["production"] = families_production_phase(dev, card,
                                                          Path(tmp))
        t = phase_time("families, production recipes (row 13)", t)
        heston_datagen_phase(card, dev, {k: v["heston"]
                                         for k, v in epoch_s.items()})
        nd2 = step_nd2_phase(dev, card)
        nd2_launches = scaled_nd_phase(dev, card, Path(tmp))
        t = phase_time("scaled d=2 recipes (rows 9-10 at d_x 2)", t)
    serve_nd2 = serving_nd_phase(dev, card)
    t = phase_time("serving at d_x 2 (row 1)", t)
    grid_launches = grid_rollout_phase(dev, card)
    t = phase_time("grid rollout (predict_on_grid; row 6 forced)", t)
    sample_launches = sampling_phase(dev, card)
    t = phase_time("generative sampling (row 1)", t)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = cli_phase(dev, card, Path(tmp))
    t = phase_time("experiment CLIs (rows 11-12, 13, 1)", t)

    # "path" names the window each launch count was read over
    def entry(name, source, replaces, path, n, err, tm):
        ms, plain, bound, by = tm
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "path": path, "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": None}
    composed = ("production training without --shared-network (run_experiment"
                ", --kernels auto)")
    scaled = "scaled training (run_experiment)"
    f_prod = "forced production training (run_experiment, use_pallas True)"
    f_dt = ("forced production training at dt_ode_step 0.1 "
            "(run_experiment, one epoch)")
    f_default = "forced default training (run_experiment, use_pallas True)"
    bf16_scaled = ("bf16 scaled training (run_experiment, compute_dtype "
                   "bfloat16)")
    scaled_nd = "scaled d=2 training (run_experiment, black_scholes_nd)"

    def at_dx2(path, n, err, tm):
        ms, plain, bound, by = tm
        return {"path": path, "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by}
    dx2 = {"gap_scan_fwd": {"path": "serving at d_x 2 (predict_at)",
                            **serve_nd2},
           "fused_step_fwd": at_dx2(scaled_nd, nd2_launches[9],
                                    nd2["errs"][0], nd2["fused_step_fwd"]),
           "fused_step_bwd": at_dx2(scaled_nd, nd2_launches[10],
                                    nd2["errs"][1], nd2["fused_step_bwd"])}
    kernels = [
        entry("gap_scan_fwd", KERNEL_SOURCE, REPLACES,
              "serving (predict_at, NJODEFilter)", launches, max_err,
              (k_ms, p_ms, g_bound, g_by)),
        entry("train_run", TRAIN_SOURCE, TRAIN_REPLACES,
              "default training (run_experiment)", t_launches, t_err,
              (tk_ms, tp_ms, t_bound, t_by)),
        entry("walk_scan_fwd", WALK_SOURCE, "njode_tpu/ops/walk_scan.py:148",
              composed, separate[7], wf_err, times["walk_fwd"]),
        entry("walk_scan_bwd", WALK_SOURCE, "njode_tpu/ops/walk_scan.py:226",
              composed, separate[8], wb_err, times["walk_bwd"]),
        entry("walk_train", WALK_TRAIN_SOURCE,
              "njode_tpu/ops/walk_train.py:178",
              "production training (run_experiment)", prod_launches, wt_err,
              times["walk_train"]),
        entry("fused_step_fwd", STEP_SOURCE,
              "njode_tpu/ops/fused_step.py:223", scaled, step_launches[0],
              sf_err, times["fused_step_fwd"]),
        entry("fused_step_bwd", STEP_SOURCE,
              "njode_tpu/ops/fused_step.py:316", scaled, step_launches[1],
              sb_err, times["fused_step_bwd"]),
        entry("gap_train_fwd_full", GAP_TRAIN_SOURCE,
              "njode_tpu/ops/gap_scan.py:134", f_dt, forced[2],
              gap_errs["full"][0], forced_times[2]),
        entry("gap_train_fwd_checkpointed", GAP_TRAIN_SOURCE,
              "njode_tpu/ops/gap_scan.py:235", f_prod, forced[3],
              gap_errs["checkpointed"][0], forced_times[3]),
        entry("gap_train_bwd_full", GAP_TRAIN_SOURCE,
              "njode_tpu/ops/gap_scan.py:422", f_dt, forced[4],
              gap_errs["full"][1], forced_times[4]),
        entry("gap_train_bwd_checkpointed", GAP_TRAIN_SOURCE,
              "njode_tpu/ops/gap_scan.py:295", f_prod, forced[5],
              gap_errs["checkpointed"][1], forced_times[5]),
        entry("fused_cell", CELL_SOURCE, "njode_tpu/ops/fused_cell.py:73",
              f_default, forced[6], cell_err, forced_times[6]),
        entry("fused_step_fwd_bf16", STEP_SOURCE,
              "njode_tpu/ops/fused_step.py:223", bf16_scaled,
              bf16_launches["9b"], bf_f_err, times["fused_step_fwd_bf16"]),
        entry("fused_step_bwd_bf16", STEP_SOURCE,
              "njode_tpu/ops/fused_step.py:316", bf16_scaled,
              bf16_launches["10b"], bf_b_err, times["fused_step_bwd_bf16"]),
        entry("train_run_bf16", TRAIN_SOURCE, TRAIN_REPLACES,
              "bf16 default training (run_experiment, train_kernel_mxu "
              "bfloat16)", mxu_launches["11b"]["11b"], mxu_errs[0],
              times["11b"]),
        entry("walk_train_bf16", WALK_TRAIN_SOURCE,
              "njode_tpu/ops/walk_train.py:178",
              "bf16 production training (run_experiment, train_kernel_mxu "
              "bfloat16)", mxu_launches["13b"]["13b"], mxu_errs[1],
              times["13b"])]
    # the rows this slice also runs at d_x 2 carry those numbers too
    for k in kernels:
        if k["name"] in dx2:
            k["d_x2"] = dx2[k["name"]]
    # the launches of the inference surface's and the CLIs' windows
    grid = f"{GRID_PATHS:,} paths x {GRID_STEPS + 1} grid points"
    also = {
        "gap_scan_fwd": [
            (f"sample_paths, {grid}, gaussian from x0",
             sample_launches[("gaussian", "x0")]),
            (f"sample_paths, {grid}, gaussian from a 10-observation prefix",
             sample_launches[("gaussian", "prefix")]),
            ("CLI experiment_black_scholes with scripts/run_black_scholes.sh"
             "'s flags, 2 epochs (validation)", cli_launches["production"][1])],
        "fused_cell": [(f"forced predict_on_grid (use_pallas True), {grid}",
                        grid_launches[6])],
        "train_run": [("CLI experiment_black_scholes defaults, 3 epochs",
                       cli_launches["default"])]
        + [(f"CLI {name} defaults, 2 epochs", cli_launches[name])
           for name in (eou.NAME, ehe.NAME, ehy.NAME)],
        "walk_train": [("CLI experiment_black_scholes with scripts/"
                        "run_black_scholes.sh's flags, 2 epochs",
                        cli_launches["production"][13])]}
    for k in kernels:
        if k["name"] in also:
            k["also"] = [{"path": p, "launches": n}
                         for p, n in also[k["name"]]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
