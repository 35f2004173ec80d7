#!/bin/bash
# Train MeBT on the PyTorch port (the JAX package's scripts/train_config_log.sh;
# reference scripts/train_config_log_gpus.sh):
#
#   bash mebt_tpu_torch/scripts/train_config_log.sh CONFIG LOGDIR [NGPU] [extra args...]
#
# NGPU (default 1) is the reference's GPU count: above 1 the run goes
# through torchrun, one process a GPU, with --multihost (data parallel;
# exp.model_parallel=K among the extra arguments for tensor parallelism).
# Further arguments go on to mebt_tpu_torch.cli.train, after the recipe's
# own, so they override them (--max_steps 2, --random_vqgan, dot-list
# overrides such as exp.exact_lr=1e-4).
#
# Optional env: DEVICE (default cuda; cpu runs the plain versions of the
# kernels, and gloo under torchrun), PYTHON (default python).
# Run from the repository root, or with the root on PYTHONPATH.
set -e

if [ $# -lt 2 ]; then
    echo "usage: $0 CONFIG LOGDIR [NGPU] [extra args...]" >&2
    exit 2
fi
CONFIG=$1
LOGDIR=$2
shift 2
NGPU=1
if [ $# -gt 0 ] && [[ $1 =~ ^[0-9]+$ ]]; then
    NGPU=$1
    shift
fi
DEVICE=${DEVICE:-cuda}
PYTHON=${PYTHON:-python}

ARGS=(--base "$CONFIG" --logdir "$LOGDIR" --device "$DEVICE" --max_steps 2000000
      exp.accumulate_grad_batches=1 "$@")
if [ "$NGPU" -gt 1 ]; then
    exec $PYTHON -m torch.distributed.run --standalone --nproc_per_node "$NGPU" \
        -m mebt_tpu_torch.cli.train --multihost "${ARGS[@]}"
fi
exec $PYTHON -m mebt_tpu_torch.cli.train "${ARGS[@]}"
