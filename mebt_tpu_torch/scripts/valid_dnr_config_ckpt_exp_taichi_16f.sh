#!/bin/bash
# Usage: bash mebt_tpu_torch/scripts/valid_dnr_config_ckpt_exp_taichi_16f.sh CONFIG CKPT EXP_NAME
# Taichi-16f eval recipe on the PyTorch port (BASELINE.md row 3)
set -e
export CONFIG=$1 CKPT=$2 EXP=$3
export LENGTH=16 DATASET=taichi DATA_PATH=datasets/vqgan_data/taichi_fvd N_SAMPLE=2048 BATCH=16 RUNS="0 1 2 3 4 5 6 7 8 9"
export N_STEPS=64 CTEMP=2.0 M=8 N_REVISE=2 REVISE_T=0.3
export EXTRA_MEASURE="--sample_every_n_frames 4"
bash "$(dirname "$0")/valid_dnr.sh"
