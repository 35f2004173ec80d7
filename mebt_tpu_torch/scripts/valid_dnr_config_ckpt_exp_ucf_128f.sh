#!/bin/bash
# Usage: bash mebt_tpu_torch/scripts/valid_dnr_config_ckpt_exp_ucf_128f.sh CONFIG CKPT EXP_NAME
# UCF-128f eval recipe on the PyTorch port; FVD vs train split (BASELINE.md row 6)
set -e
export CONFIG=$1 CKPT=$2 EXP=$3
export LENGTH=128 DATASET=ucf101 DATA_PATH=datasets/vqgan_data/ucf_128 N_SAMPLE=512 BATCH=4 RUNS="0 1 2 3 4"
export N_STEPS=32 CTEMP=2.0 M=2 N_REVISE=32 REVISE_T=0.1
export TOP_K=32 BOOTSTRAP=64 EXTRA_MEASURE="--train"
bash "$(dirname "$0")/valid_dnr.sh"
