"""Host ms a tick in the port's ``policy.prep.upload`` spans (frames, ids, masks and states
pinned and queued to the card), median over the profiled ticks."""

from portbench import spans


def read(run):
    return spans.median_ms_below("policy.forward", "policy.prep.upload")
