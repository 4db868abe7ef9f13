#!/bin/bash
# The rk4 recipe of scripts/run_production_rk4.sh (the same flags) on the
# PyTorch port, on one CUDA card: python -m
# njode_tpu_torch.experiments.experiment_black_scholes.  Its 0.01 grid is not
# a multiple of --dt-ode-step 0.05, so --kernels auto keeps the grid walk off
# and trains on the composed per-gap rk4 loop: no hand-written kernel runs.
# Its times on the card are in PERF.md.  Extra flags pass through, e.g.
# --device cpu for a CPU run or --no-plots where matplotlib is absent.
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p logs
python -u -m njode_tpu_torch.experiments.experiment_black_scholes \
    --n-train 10000 --n-val 2000 --hidden-dim 50 --shared-network \
    --dt-ode-step 0.05 --ode-solver rk4 --n-epochs 200 --batch-size 128 \
    --moment-weights 1.0 10.0 \
    "$@" 2>&1 | tee "logs/njode_bs_rk4_torch_$(date +%Y%m%d_%H%M%S).log"
