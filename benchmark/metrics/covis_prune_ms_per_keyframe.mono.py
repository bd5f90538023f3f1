"""The backend's covisibility prune after each keyframe: the program's
span ``backend.covis_prune`` (the window's observation counts, the prune
mask and, in monocular mapping, the prune itself), its mean over the
window's keyframes before the traced one, in milliseconds."""


def read(run):
    s = run.spans.get("backend.covis_prune")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
