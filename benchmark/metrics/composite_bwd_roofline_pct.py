"""The backward compositing kernels' share of their roofline, in per
cent: the least time the backward of the traced part's sampled
differentiated compositing calls needs (``work.py``) over those
backward kernels' time in the trace."""

from benchmark.work import share


def read(run):
    return share(run, "bwd")
