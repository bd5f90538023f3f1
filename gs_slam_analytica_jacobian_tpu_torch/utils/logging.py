"""Tagged logger (the port's copy of utils/logging.py)."""

from __future__ import annotations

import sys
import time

_START = time.time()


def Log(*args, tag: str = "GS-SLAM-TPU") -> None:
    msg = " ".join(str(a) for a in args)
    print(f"[{time.time() - _START:8.2f}s][{tag}] {msg}", file=sys.stderr,
          flush=True)
