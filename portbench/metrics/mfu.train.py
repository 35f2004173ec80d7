"""Whole-step share of the card's peaks over the traced steps: 3 x the
forward's matmuls at 989 TFLOP/s bf16, the VQGAN encoder's convolutions
at 67 TFLOP/s fp32, K9's 2 M K D at 495 TFLOP/s TF32, %."""

from portbench import readers


def read(rec):
    return readers.mfu(rec)
