"""request_s: the mean wall of a request, every request's wall (host clock,
ending in a synchronize) summed over the number of requests. One client
without think time: the window's request time over its requests, so a
stall in any request counts."""


def read(run):
    walls = [it.wall_s for it in run.items] if run.unit == "request" else []
    return sum(walls) / len(walls) if walls else None
