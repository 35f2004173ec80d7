"""Device idle ms a video in which the host was inside no mebt:: span:
what the program's spans do not explain."""

from portbench import spans


def read(rec):
    return spans.untraced_idle_ms(rec, "mebt::vqgan_decode", "videos")
