"""drain_wait_us_per_event.stream (us/event): the server loop's
``drain_wait`` stage seconds in the window per delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("drain_wait")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
