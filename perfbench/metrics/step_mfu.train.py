"""The FLOP count that the window's work needs (``perfbench/flops.py``)
over the window and the card's bfloat16 peak, in percent."""

from perfbench.flops import PEAK_BF16_FLOPS


def read(rec):
    if rec["kind"] != "train" or not rec["flops"]:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK_BF16_FLOPS
