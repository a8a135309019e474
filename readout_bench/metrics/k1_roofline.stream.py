"""k1_roofline.stream (%): the featurizer's least time for the window's
delivered events (yardstick.k1_least_s) over its device time in the
trace (kernel ``yprofile_kernel``)."""

from readout_bench import yardstick
from readout_bench.trace import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx.get("trace"), "yprofile_kernel")
    n = ctx["counts"]["events"]
    if t <= 0 or not n:
        return None
    return 100.0 * yardstick.k1_least_s(n) / t
