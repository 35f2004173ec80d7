"""Device idle share of the traced generation batches, %."""

from portbench import readers


def read(rec):
    return readers.idle_share(rec)
