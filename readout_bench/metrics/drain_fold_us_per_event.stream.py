"""drain_fold_us_per_event.stream (us/event): the server loop's host work
on drained results in the window (``report()["stages"]``:
``drain_wait.fold``, the kept-prefix copies, merge, a ``ScoredEvent`` an
event and the disagreement fold, plus ``observe``, the latency ledger and
the result sort) per delivered event."""


def read(ctx):
    c = ctx["counts"]
    st = c["stages"]
    fold = st.get("drain_wait.fold")
    if not c["events"] or fold is None or fold["calls"] <= 0:
        return None
    s = fold["seconds"] + st.get("observe", {"seconds": 0.0})["seconds"]
    return s / c["events"] * 1e6
