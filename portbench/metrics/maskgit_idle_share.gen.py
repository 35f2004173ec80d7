"""Device idle share inside the device extents of the program's MaskGIT
passes (the activity launched inside each mebt::decode.maskgit), %."""

from portbench import spans


def read(rec):
    return spans.pass_idle_share(rec, "mebt::decode.maskgit")
