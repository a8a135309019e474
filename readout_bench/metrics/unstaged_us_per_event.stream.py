"""unstaged_us_per_event.stream (us/event): the host seconds of the
server's ``poll`` that none of its direct child stages covers, in the
window (``report()["stages"]``: ``poll`` less ``coalesce``,
``stack_frames``, ``launch_fused``, ``sparse_pack``, ``enqueue_d2h``,
``drain_wait``, ``observe`` and ``scrub``) per delivered event."""

CHILDREN = ("coalesce", "stack_frames", "launch_fused", "sparse_pack",
            "enqueue_d2h", "drain_wait", "observe", "scrub")


def read(ctx):
    c = ctx["counts"]
    poll = c["stages"].get("poll")
    if not c["events"] or poll is None or poll["calls"] <= 0:
        return None
    s = poll["seconds"] - sum(v["seconds"] for k, v in c["stages"].items()
                              if k in CHILDREN)
    return s / c["events"] * 1e6
