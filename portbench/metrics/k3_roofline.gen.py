"""K3's share of its roofline: 2 R D V at 989 TFLOP/s over K3's device
time, R the rows the plans need."""

from portbench import readers


def read(rec):
    return readers.head_roofline(rec, "K3")
