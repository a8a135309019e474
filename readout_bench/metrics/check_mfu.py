"""check_mfu (%): the whole window's share of the chip's peak: the least
time of the window's checked events (yardstick.check_least_s) over the
window's seconds."""

from readout_bench import yardstick


def read(ctx):
    if not ctx.get("window_s"):
        return None
    n = ctx["counts"]["events"]
    if not n:
        return None
    return 100.0 * yardstick.check_least_s(ctx["sizes"][0], n) / ctx["window_s"]
