"""check_events_per_s (events/s): events scored through the section 5
check's fabric path (``ReadoutChip.infer_raw`` on ``KernelBackend()``)
in the window, divided by the window's seconds (the window ends when
its last chunk returns)."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return ctx["counts"]["events"] / ctx["window_s"]
