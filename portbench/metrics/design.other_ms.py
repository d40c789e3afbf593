"""design.other_ms: a design's wall less its targets stage's ``scan``,
``annotate`` and ``postprocess`` phases, per request, in ms: candidate
enumeration, the library build and the selection filters."""


def read(run):
    items = [it for it in run.items if it.work.get("design")]
    if not items:
        return None
    phases = ("scan", "annotate", "postprocess")
    return 1e3 * sum(it.wall_s - sum(it.spans.get(p, 0.0) for p in phases)
                     for it in items) / len(items)
