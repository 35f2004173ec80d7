"""K7's share of its roofline over the traced steps: each call's least time
(operations at 989 TFLOP/s or bytes at 3.35 TB/s) over K7's device time,
%."""

from portbench import readers


def read(rec):
    return readers.k7_roofline(rec)
