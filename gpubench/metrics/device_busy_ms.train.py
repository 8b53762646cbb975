"""Device ms per profiled training step: the time in which any operation ran
on the card (the union of their intervals, so that operations that overlap
count once), averaged over the profiled steps. It leaves out the host's
share of the step, which sets `train_steps_per_s`'s spread between runs, so
it holds from run to run where that rate does not."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return trace["busy_ms"]
