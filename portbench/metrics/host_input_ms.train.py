"""Host ms a step in the loader's next batch and the trainer's
prepare_batch (the masks, made on the host)."""

from portbench import readers


def read(rec):
    return readers.host_ms(rec, rec["work"]["input_spans"], "steps")
