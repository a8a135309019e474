"""drain_sync_us_per_event.stream (us/event): the server loop's
``drain_wait.sync`` stage seconds in the window (``report()["stages"]``:
the host blocked on a batch's CUDA events) per delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("drain_wait.sync")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
