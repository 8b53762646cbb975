"""A view's share of one H100's peak: the frozen roofline's ideal of
preprocess, binning and the blend (gpubench/roofline.py, on the profiled
views) over the mean view of the run's window outside the profiled views
(call to image on the host), in percent."""


def read(trace):
    if trace.get("kind") != "render":
        return None
    return 100.0 * sum(trace["ideal_ms"].values()) / trace["step_ms_untraced"]
