"""The monocular keyframe hand-over's depth: the program's span
``frontend.mono_depth`` (``mono_initial_depth``: the copies of the
hand-over render's depth and opacity to the host, which wait for that
render, then the median, std and noise on the host), its mean over the
window's keyframes before the traced one, in milliseconds."""


def read(run):
    s = run.spans.get("frontend.mono_depth")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
