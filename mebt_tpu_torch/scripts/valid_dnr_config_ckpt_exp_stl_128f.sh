#!/bin/bash
# Usage: bash mebt_tpu_torch/scripts/valid_dnr_config_ckpt_exp_stl_128f.sh CONFIG CKPT EXP_NAME
# STL-128f eval recipe on the PyTorch port (BASELINE.md row 2)
set -e
export CONFIG=$1 CKPT=$2 EXP=$3
export LENGTH=128 DATASET=stl DATA_PATH=datasets/vqgan_data/stl_128 N_SAMPLE=512 BATCH=2 RUNS="0 1 2 3 4"
export N_STEPS=32 CTEMP=4.0 M=2 N_REVISE=2 REVISE_T=0.7
export TOP_K=32 BOOTSTRAP=64
bash "$(dirname "$0")/valid_dnr.sh"
