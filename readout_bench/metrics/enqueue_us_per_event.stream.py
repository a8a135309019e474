"""enqueue_us_per_event.stream (us/event): the server loop's
``enqueue_d2h`` stage seconds in the window (``report()["stages"]``: the
pinned result buffers, the asynchronous device-to-host copies and the
CUDA events a batch) per delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("enqueue_d2h")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
