"""Device ms a step of the kernels launched inside the optimizer's update
(mebt::optimizer): gradient norm, clipping, AdamW."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, "mebt::optimizer", "steps")
