"""B1 (csrc/composite_fwd.cu) in training: the frozen roofline's ideal
(gpubench/roofline.py, on the profiled inputs) over the device ms under the
port's range `composite_fwd`, in percent; nothing where the range holds no
time."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    ms = trace["stage_ms"]["composite_fwd"]
    if ms <= 0:
        return None
    return 100.0 * trace["ideal_ms"]["composite_fwd"] / ms
