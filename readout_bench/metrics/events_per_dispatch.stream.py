"""events_per_dispatch.stream (events/dispatch): delivered events in the
window per fused-frontend dispatch (``launch_fused`` calls in
``report()["stages"]``: one a micro-batch)."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("launch_fused")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return c["events"] / st["calls"]
