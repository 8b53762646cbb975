"""Device ms per training step under the port's range `densify stats + adam`
(train/optim)."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return trace["stage_ms"]["densify stats + adam"]
