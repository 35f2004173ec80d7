"""Host ms a step in which the loader's main thread waits on its workers
(mebt::loader_wait)."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "mebt::loader_wait", "steps")
