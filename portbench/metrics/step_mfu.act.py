"""Model FLOPs of the window's ticks over its seconds, per cent of the bf16 peak."""

from portbench import readers


def read(run):
    return readers.step_mfu(run)
