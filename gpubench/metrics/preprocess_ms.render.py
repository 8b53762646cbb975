"""Device ms per view under the port's range `preprocess` (ops/projection)."""


def read(trace):
    if trace.get("kind") != "render":
        return None
    return trace["stage_ms"]["preprocess"]
