"""Mean host ms of a live decode step (mebt::step): the launch cost of
one step."""

from portbench import spans


def read(rec):
    return spans.mean_host_ms(rec, "mebt::step")
