"""h2d_us_per_event.stream (us/event): the fused frontend's
``launch_fused.h2d`` stage seconds in the window (``report()["stages"]``:
a slab's host-blocking copies of frames, y0 and valid into device
staging, with the pad zeroing) per delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("launch_fused.h2d")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
