#!/bin/bash
# Usage: bash mebt_tpu_torch/scripts/valid_dnr_config_ckpt_exp_stl_16f.sh CONFIG CKPT EXP_NAME
# STL-16f eval recipe on the PyTorch port (BASELINE.md row 1)
set -e
export CONFIG=$1 CKPT=$2 EXP=$3
export LENGTH=16 DATASET=stl DATA_PATH=datasets/vqgan_data/stl_128 N_SAMPLE=2048 BATCH=16 RUNS="0 1 2 3 4 5 6 7 8 9"
export N_STEPS=32 CTEMP=8.0 M=2 N_REVISE=2 REVISE_T=0.7

bash "$(dirname "$0")/valid_dnr.sh"
