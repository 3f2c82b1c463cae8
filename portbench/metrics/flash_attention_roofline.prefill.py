"""flash_attention_roofline.prefill: the flash kernel's share of its
roofline, in %: per launch the larger of its bytes (q, k, v and the output,
each once) at 3.35e12 B/s and its flop (4 d per kept pair) at 989e12
flop/s, summed over the configuration's launches of the traced prefills,
over the device time of the kernels named below."""
from portbench.lib import peaks

KERNELS = ("flash_wgmma_kernel", "flash_mma_kernel", "flash_kernel")


def read(ctx):
    seconds = ctx.trace.seconds(lambda o: any(k in o.name for k in KERNELS))
    launches = ctx.work.get("flash", [])
    if seconds <= 0 or not launches:
        return None
    least = sum(peaks.bound(b, f) for f, b in launches) * ctx.prefills
    return 100.0 * least / seconds
