"""Device ms per training step under the port's range `appearance + loss`
(models/appearance, utils/loss), forward only."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return trace["stage_ms"]["appearance + loss"]
