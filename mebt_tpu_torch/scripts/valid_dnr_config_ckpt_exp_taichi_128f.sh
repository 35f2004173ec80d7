#!/bin/bash
# Usage: bash mebt_tpu_torch/scripts/valid_dnr_config_ckpt_exp_taichi_128f.sh CONFIG CKPT EXP_NAME
# Taichi-128f eval recipe on the PyTorch port (BASELINE.md row 4)
set -e
export CONFIG=$1 CKPT=$2 EXP=$3
export LENGTH=128 DATASET=taichi DATA_PATH=datasets/vqgan_data/taichi_trainval N_SAMPLE=512 BATCH=4 RUNS="0 1 2 3 4"
export N_STEPS=32 CTEMP=4.0 M=4 N_REVISE=2 REVISE_T=0.1
export TOP_K=32 BOOTSTRAP=64
bash "$(dirname "$0")/valid_dnr.sh"
