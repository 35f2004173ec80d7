"""Device ms a video of the kernels that are none of K1-K9 and not the
VQGAN decode's: GEMMs, norms, GELU, casts, sampling."""

from portbench import readers


def read(rec):
    return readers.other_ms(rec, rec["work"]["vqgan_span"], "videos")
