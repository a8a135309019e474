"""dispatch_device_us_per_event.stream (us/event): the device seconds of
the server's dispatches in the window (``report()["stages"]``
``dispatch_device``: a CUDA event pair a slab and dispatch, from before
the first staging copy to after the results' device-to-host copies) per
delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"].get("dispatch_device")
    if not c["events"] or st is None or st["calls"] <= 0:
        return None
    return st["seconds"] / c["events"] * 1e6
