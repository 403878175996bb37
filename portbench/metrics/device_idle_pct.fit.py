"""The device: the share of the traced window with no kernel, copy or
set on the card, in %."""
from portbench import yardstick as ys


def read(t):
    return ys.idle_pct(t)
