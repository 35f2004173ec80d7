"""Device ms a video of the kernels launched inside the benchmark's range
around the VQGAN instance's decode."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, rec["work"]["vqgan_span"], "videos")
