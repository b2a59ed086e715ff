"""Host ms a step in the port's ``train.feed`` spans (the next batch prepared, tokenized, pinned
and queued on the step's own thread), over the profiled steps."""

from portbench import spans


def read(run):
    return spans.ms_per_unit("train.step", "train.feed")
