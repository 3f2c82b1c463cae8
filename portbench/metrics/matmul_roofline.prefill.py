"""matmul_roofline.prefill: the matrix products' share of their roofline, in
%: the configuration's matmul flop per prefill (``work``'s
``matmul_flop``: the projections over every token, the experts at top-k
with no capacity padding, the head at the last position only) at 989e12
flop/s, over the device time of the cuBLAS kernels (by name) per prefill."""
from portbench.lib import peaks

MATMUL = ("gemm", "nvjet", "cutlass", "xmma", "gemv")


def read(ctx):
    seconds = ctx.trace.seconds(
        lambda o: any(p in o.name.lower() for p in MATMUL))
    if seconds <= 0:
        return None
    return 100.0 * ctx.work["matmul_flop"] * ctx.prefills \
        / peaks.PEAK_BF16_FLOP_PER_S / seconds
