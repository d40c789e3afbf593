"""scan_roofline: the least time the window's scans need, over the device's
busy time inside its requests, in %. The least time is the larger of the
operations (2 for each of 4L one-hot rows, for each pair of a spacer and a
PAM-valid site on either strand) at the int8 peak and the bytes (codes read
once, hits written once) at the memory peak: ``portbench.roofline``. The
busy time is the union of every device interval inside the requests, every
kernel counted, so the share cannot pass 100% and stays honest when work
moves between engines. Nothing to read without a trace or device time."""

import sys

from portbench import roofline


def read(run):
    if run.unit != "request" or not run.items or any(it.busy_s is None for it in run.items):
        return None
    busy = sum(it.busy_s for it in run.items)
    if busy <= 0:
        return None
    least = [roofline.least_time(it.work["ops"], it.work["bytes"]) for it in run.items]
    bound = {b for _, b in least}
    print(f"portbench: scan_roofline bound by {'/'.join(sorted(bound))}, "
          f"{sum(t for t, _ in least):.6f} s of {busy:.6f} s busy; card power.limit "
          f"{run.card.get('power.limit', 'not read')}", file=sys.stderr)
    return 100.0 * sum(t for t, _ in least) / busy
