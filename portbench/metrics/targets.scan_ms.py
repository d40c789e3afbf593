"""targets.scan_ms: the program's ``scan`` phase per request, in ms, from
the harness's collector that ``run_targets`` fills (``phases=``)."""


def read(run):
    if run.unit != "request" or not run.items:
        return None
    return 1e3 * sum(it.spans.get("scan", 0.0) for it in run.items) / len(run.items)
