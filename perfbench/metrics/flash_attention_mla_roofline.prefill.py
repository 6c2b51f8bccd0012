"""B2 (flash_attention) with q and k wider than v: its work counted at both
widths (``yardstick/mla.py``) at the peaks over its device time, %."""
from harness import readers


def read(run):
    return readers.roofline(run, "flash_attention_mla")
