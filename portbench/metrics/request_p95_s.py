"""request_p95_s: the 95th percentile of all request walls in the window
(numpy's linear interpolation)."""

import numpy as np


def read(run):
    walls = [it.wall_s for it in run.items] if run.unit == "request" else []
    return float(np.percentile(walls, 95)) if walls else None
