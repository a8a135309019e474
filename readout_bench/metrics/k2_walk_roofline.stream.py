"""k2_walk_roofline.stream (%): the fabric walk's least time for the
window's delivered events, chip by chip (yardstick.fabric_least_s:
bytes, or logic operations at the integer rate, whichever is larger)
over its device time in the trace in every form of the walk: the
descriptor pass (``desc_kernel``), the staged or split walk
(``eval_words_voted_kernel``), the streamed walk
(``eval_words_streamed_kernel``) and the vote pass (``vote_kernel``)."""

from readout_bench import yardstick
from readout_bench.trace import kernel_seconds

KERNELS = ("desc_kernel", "eval_words_voted_kernel",
           "eval_words_streamed_kernel", "vote_kernel")


def read(ctx):
    t = kernel_seconds(ctx.get("trace"), *KERNELS)
    c = ctx["counts"]
    if t <= 0 or not c["events"]:
        return None
    return 100.0 * yardstick.fabric_least_s(ctx["sizes"],
                                            c["events_per_chip"]) / t
