"""Device ms a step of the kernels that are none of K1-K9 and not the
encode's: GEMMs, norms, GELU, dropout, casts, AdamW."""

from portbench import readers


def read(rec):
    return readers.other_ms(rec, rec["work"]["encode_span"], "steps")
