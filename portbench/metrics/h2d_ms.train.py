"""Host ms a step in the batch's copy to the card (mebt::h2d): the pageable
copy as the host sees it."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "mebt::h2d", "steps")
