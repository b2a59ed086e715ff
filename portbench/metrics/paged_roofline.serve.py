"""Least time of the decoder's paged_attention calls over the device time inside the ranges around them."""

from portbench import readers


def read(run):
    return readers.roofline(run, "paged")
