"""Least time of the RepMixer block calls over the device time inside the ranges around each block."""

from portbench import readers


def read(run):
    return readers.roofline(run, "repmixer")
