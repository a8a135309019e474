"""stream_mfu (%): the whole window's share of the chip's peak: the
least time of the window's delivered events from frame to verdict
(yardstick.served_least_s) over the window's seconds."""

from readout_bench import yardstick


def read(ctx):
    if not ctx.get("window_s"):
        return None
    c = ctx["counts"]
    if not c["events"]:
        return None
    return 100.0 * yardstick.served_least_s(
        ctx["sizes"], c["events_per_chip"], c["kept"],
        ctx["sparse"]) / ctx["window_s"]
