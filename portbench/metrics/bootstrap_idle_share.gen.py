"""Device idle share inside the device extents of the program's bootstrap
passes (the activity launched inside each mebt::decode.bootstrap), %."""

from portbench import spans


def read(rec):
    return spans.pass_idle_share(rec, "mebt::decode.bootstrap")
