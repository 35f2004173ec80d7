"""Whole-batch share of the card's peaks: the transformer's matmuls (ideal
counts of the plans) at 989 TFLOP/s bf16 and the VQGAN decoder's
convolutions at 67 TFLOP/s fp32, over the traced window, %."""

from portbench import readers


def read(rec):
    return readers.mfu(rec)
