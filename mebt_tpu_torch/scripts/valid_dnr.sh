#!/bin/bash
# The evaluation recipe on the PyTorch port: MaskGIT sample -> FVD, then
# the revise-only draft-and-revise of those code maps -> FVD (reference
# scripts/valid_dnr_*.sh; the same environment and output names as the
# JAX package's scripts/valid_dnr.sh). Run from the repository root, or
# with the root on PYTHONPATH; outputs go under results/$EXP.
#
# Required env (set by the per-workload wrappers):
#   CONFIG CKPT EXP LENGTH DATASET DATA_PATH N_SAMPLE BATCH RUNS
#   N_STEPS CTEMP M N_REVISE REVISE_T
# Optional: TOP_K BOOTSTRAP EXTRA_SAMPLE EXTRA_MEASURE I3D_CKPT,
#   DEVICE (default cuda; cpu runs the plain versions of the kernels),
#   PYTHON (default python)
set -e

TOPK_ARGS=""
TOPK_TAG=""
if [ -n "$TOP_K" ]; then
    TOPK_ARGS="--top_k $TOP_K"
    TOPK_TAG="_k${TOP_K}"
fi
BS_ARGS=""
if [ -n "$BOOTSTRAP" ]; then
    BS_ARGS="--bootstrap $BOOTSTRAP"
fi
I3D_CKPT=${I3D_CKPT:-ckpts/i3d_pretrained_400.pt}
DEVICE=${DEVICE:-cuda}
PYTHON=${PYTHON:-python}

for RUN in $RUNS; do
    MG_TAG="VID_n_steps${N_STEPS}${TOPK_TAG}_temp1.0_ctemp${CTEMP}linear_maskgit_cosine_no_phase_run${RUN}"
    NP_DIR="results/${EXP}/numpy_files_${LENGTH}/${DATASET}"

    $PYTHON -m mebt_tpu_torch.cli.sample --base $CONFIG \
        --gpt_ckpt "$CKPT" --exp_name "$EXP" --device $DEVICE \
        --vid_c_temp $CTEMP --total_length $LENGTH --vid_n_steps $N_STEPS \
        --context_size $LENGTH --step_size $LENGTH \
        --dataset $DATASET --n_sample $N_SAMPLE --run $RUN \
        --batch_size $BATCH --save_videos --save_n 5 \
        --decoding_strategy maskgit --no_phase $TOPK_ARGS $BS_ARGS \
        --save_codemap $EXTRA_SAMPLE

    $PYTHON -m mebt_tpu_torch.cli.measure_fvd --batch_size 16 --device $DEVICE \
        --np_file ${NP_DIR}/${MG_TAG}.npy \
        --data_path $DATA_PATH --image_folder \
        --sequence_length $LENGTH --n_sample $N_SAMPLE --resolution 128 \
        --i3d_ckpt $I3D_CKPT $EXTRA_MEASURE

    DNR_TAG="VID_dnr_nd${N_STEPS}_dt0.0_nr${N_REVISE}_rt${REVISE_T}_M${M}_ctemp${CTEMP}_run${RUN}"

    $PYTHON -m mebt_tpu_torch.cli.dnr --base $CONFIG \
        --gpt_ckpt "$CKPT" --exp_name "$EXP" --device $DEVICE --total_length $LENGTH \
        --n_revise $N_REVISE --M $M --revise_t $REVISE_T \
        --np_draft ${NP_DIR}/${MG_TAG}_codemap.npy \
        --context_size $LENGTH --step_size $LENGTH \
        --dataset $DATASET --n_sample $N_SAMPLE --run $RUN \
        --batch_size $BATCH --save_videos --save_n 5

    $PYTHON -m mebt_tpu_torch.cli.measure_fvd --batch_size 16 --device $DEVICE \
        --np_file ${NP_DIR}/${DNR_TAG}.npy \
        --data_path $DATA_PATH --image_folder \
        --sequence_length $LENGTH --n_sample $N_SAMPLE --resolution 128 \
        --i3d_ckpt $I3D_CKPT $EXTRA_MEASURE
done
