"""Device idle share of the traced training steps, %."""

from portbench import readers


def read(rec):
    return readers.idle_share(rec)
