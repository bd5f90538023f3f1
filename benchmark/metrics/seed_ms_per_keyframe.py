"""The backend's keyframe intake: the harness's span around
``BackEnd.add_next_kf`` (store the keyframe, seed new Gaussians from its
depth), synchronised at both ends, its mean over the window's keyframes
in milliseconds."""


def read(run):
    s = run.spans.get("seed")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
