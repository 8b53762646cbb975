"""Share of the profiled training steps' wall time in which no operation ran on
the card, in percent: 1 - the time in which any device operation ran (the
union of their intervals, so that operations that overlap count once) over
the same training steps' wall time, as the line's `device.busy_s` and
`device.window_s` give them. The profiler adds host time to every launch,
so where the host sets the pace this reads above the idle share of an
unprofiled step."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
