"""b3_roofline.check (%): the banded selection kernel's least time for
the window's checked events (yardstick.fabric_least_s) over its device
time in the trace (``sel_lists_kernel`` and ``lut_eval_kernel``, the
two passes of one B2/B3 call)."""

from readout_bench import yardstick
from readout_bench.trace import kernel_seconds

KERNELS = ("sel_lists_kernel", "lut_eval_kernel")


def read(ctx):
    t = kernel_seconds(ctx.get("trace"), *KERNELS)
    n = ctx["counts"]["events"]
    if t <= 0 or not n:
        return None
    return 100.0 * yardstick.fabric_least_s(ctx["sizes"][:1], [n]) / t
