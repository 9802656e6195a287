"""mfu: the model FLOPs the window's drains did (counted from the cell's
shapes by the reference module's ``slice_flops``) over their seconds and
the card's dense bf16 peak, in percent."""
from kbench import work


def read(rec):
    seconds = sum(d["call_s"] for d in rec["drains"])
    if seconds <= 0:
        return None
    flops = sum(d["flops"] for d in rec["drains"])
    return 100.0 * flops / seconds / work.PEAK_FLOPS["bfloat16"]
