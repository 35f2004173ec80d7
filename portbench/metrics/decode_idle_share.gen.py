"""Device idle share of the traced window outside the VQGAN decode's device
extents: the decode engine's, %."""

from portbench import readers


def read(rec):
    return readers.idle_share_outside(rec, rec["work"]["vqgan_span"])
