"""The training step's share of one H100's peak: the frozen roofline's ideal of
the whole step (gpubench/roofline.py, on the profiled steps' inputs) over
the mean untraced step of the traced run's window, in percent."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return 100.0 * sum(trace["ideal_ms"].values()) / trace["step_ms_untraced"]
