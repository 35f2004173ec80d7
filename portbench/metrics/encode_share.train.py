"""Share of the traced steps' device busy time launched inside the
program's mebt::encode_codes range: the VQGAN encoder and K9, %."""

from portbench import readers


def read(rec):
    return readers.span_share(rec, rec["work"]["encode_span"])
