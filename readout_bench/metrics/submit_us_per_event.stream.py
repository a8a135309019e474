"""submit_us_per_event.stream (us/event): the server loop's ``submit``
stage seconds in the window (``report()["stages"]``: ``submit_frames``'
per-event queueing and admission, a call a block) per delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("submit")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
