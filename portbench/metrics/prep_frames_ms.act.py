"""Host ms a tick in the port's ``policy.prep.frames`` spans (frames and states made float32
BCHW arrays), median over the profiled ticks."""

from portbench import spans


def read(run):
    return spans.median_ms_below("policy.forward", "policy.prep.frames")
