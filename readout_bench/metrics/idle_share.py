"""idle_share.<cell kind> (%): the share of the traced window in which
the card ran no kernel, copy or memset (the union of the device's
activity in the profiler's trace). One reader for every cell kind: each
kind's metric moves its own end-to-end metric."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
