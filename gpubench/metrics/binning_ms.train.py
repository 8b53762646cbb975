"""Device ms per training step under the port's range `binning` (ops/binning)."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return trace["stage_ms"]["binning"]
