"""Device operations (kernels, copies, fills) launched per training step, each
a host dispatch: the profiler's count over the profiled steps."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    return trace["launches"]
