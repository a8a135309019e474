"""coalesce_us_per_event.stream (us/event): the server loop's
``coalesce`` stage seconds in the window (``report()["stages"]``: the
queue take and kind split, each pass's grouping and batch meta) per
delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("coalesce")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
