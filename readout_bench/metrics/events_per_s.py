"""events_per_s (events/s): events delivered (scored and drained by the
server, its per-chip ``n_in``) in the window over all sensors, divided
by the window's seconds."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return ctx["counts"]["events"] / ctx["window_s"]
