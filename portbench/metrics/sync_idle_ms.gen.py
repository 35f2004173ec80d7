"""Device idle ms a video after the program's reads of the device's results
(from each mebt::fetch's end to the next device activity)."""

from portbench import spans


def read(rec):
    return spans.idle_after_ms(rec, "mebt::fetch", "videos")
