"""Device kernel launches a mapping iteration: the kernels in the traced
part of the window (a keyframe's intake and its first iterations) over
the iterations traced."""


def read(run):
    if run.trace is None or not run.counters.get("traced_iters"):
        return None
    return run.trace["launches"] / run.counters["traced_iters"]
