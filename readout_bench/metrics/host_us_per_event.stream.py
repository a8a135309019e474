"""host_us_per_event.stream (us/event): the server loop's host seconds
of staging and launch in the window (``report()["stages"]``:
``stack_frames``, ``launch_fused``, and ``sparse_pack`` and ``scrub``
where they run) per delivered event."""

STAGES = ("stack_frames", "launch_fused", "sparse_pack", "scrub")


def read(ctx):
    c = ctx["counts"]
    s = sum(v["seconds"] for k, v in c["stages"].items() if k in STAGES)
    if not c["events"] or s <= 0:
        return None
    return s / c["events"] * 1e6
