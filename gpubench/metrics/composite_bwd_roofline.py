"""B2 (csrc/composite_bwd.cu): the frozen roofline's ideal
(gpubench/roofline.py, on the profiled inputs) over the device ms under the
port's range `composite_bwd`, in percent; nothing where the range holds no
time."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    ms = trace["stage_ms"]["composite_bwd"]
    if ms <= 0:
        return None
    return 100.0 * trace["ideal_ms"]["composite_bwd"] / ms
