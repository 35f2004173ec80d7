"""Host ms a step stacking the batch on the loader's main thread
(mebt::collate)."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "mebt::collate", "steps")
