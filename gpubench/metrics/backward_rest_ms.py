"""Device ms per training step that no range of the port holds: autograd's
backward of preprocess, the appearance net and the loss, and the few
operations outside any range."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return trace["stage_ms"]["rest"]
