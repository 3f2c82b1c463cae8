"""ssd_scan_roofline.prefill: the SSD scan's share of its roofline, in %: per
launch the larger of its bytes (x, dt, A, B, C, y and the final state, each
once) at 3.35e12 B/s and its flop (per chunk the causal half of C.B^T and of
its product with dt.x, the inter-chunk term, the state update) at 989e12
flop/s, summed over the configuration's launches of the traced prefills,
over the device time of the kernels named below (every part of a call)."""
from portbench.lib import peaks

KERNELS = ("ssd_wgmma_chunk_state", "ssd_kernel_chunk_state",
           "ssd_kernel_state_pass", "ssd_wgmma_chunk_scan",
           "ssd_kernel_chunk_scan", "ssd_kernel")


def read(ctx):
    seconds = ctx.trace.seconds(lambda o: any(k in o.name for k in KERNELS))
    launches = ctx.work.get("ssd", [])
    if seconds <= 0 or not launches:
        return None
    least = sum(peaks.bound(b, f) for f, b in launches) * ctx.prefills
    return 100.0 * least / seconds
