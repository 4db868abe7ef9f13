#!/bin/bash
# The production recipe of scripts/run_heston.sh (the same flags) on the
# PyTorch port, on one CUDA card: python -m
# njode_tpu_torch.experiments.experiment_heston.  Extra flags pass through,
# e.g. --device cpu for a CPU run or --no-plots where matplotlib is absent.
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p logs
python -u -m njode_tpu_torch.experiments.experiment_heston \
    --n-train 10000 --n-val 2000 --n-epochs 200 --batch-size 256 \
    --hidden-dim 50 --learning-rate 0.001 --num-moments 2 \
    --moment-weights 1.0 15.0 --obs-fraction 0.1 --dt-ode-step 0.01 \
    --shared-network --print-every 5 \
    "$@" 2>&1 | tee "logs/njode_heston_torch_$(date +%Y%m%d_%H%M%S).log"
