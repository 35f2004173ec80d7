#!/bin/bash
# Usage: bash mebt_tpu_torch/scripts/valid_dnr_config_ckpt_exp_ucf_16f.sh CONFIG CKPT EXP_NAME
# UCF-16f eval recipe on the PyTorch port; FVD vs train split (BASELINE.md row 5)
set -e
export CONFIG=$1 CKPT=$2 EXP=$3
export LENGTH=16 DATASET=ucf101 DATA_PATH=datasets/vqgan_data/ucf_128 N_SAMPLE=2048 BATCH=16 RUNS="0 1 2 3 4 5 6 7 8 9"
export N_STEPS=128 CTEMP=6.0 M=4 N_REVISE=4 REVISE_T=0.7
export EXTRA_MEASURE="--train"
bash "$(dirname "$0")/valid_dnr.sh"
