"""k2_device_us_per_event.stream (us/event): the fabric walk's device
seconds in the trace, in every form of the walk (the descriptor pass
``desc_kernel``, the staged or split walk ``eval_words_voted_kernel``,
the streamed walk ``eval_words_streamed_kernel`` and the vote pass
``vote_kernel``), per delivered event."""

from readout_bench.trace import kernel_seconds

KERNELS = ("desc_kernel", "eval_words_voted_kernel",
           "eval_words_streamed_kernel", "vote_kernel")


def read(ctx):
    t = kernel_seconds(ctx.get("trace"), *KERNELS)
    c = ctx["counts"]
    if t <= 0 or not c["events"]:
        return None
    return t / c["events"] * 1e6
