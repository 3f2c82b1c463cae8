"""mfu.prefill: the whole step's share of the card's bf16 peak, in %: the
flop the configuration's last-position logits need (``configs/<config>.py``
``work``: every projection, attention's kept pairs, the SSD's work, the
head at the last position only) times the prefills traced, over the traced
window, over 989e12 flop/s."""
from portbench.lib import peaks


def read(ctx):
    tr = ctx.trace
    if not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * ctx.work["flop"] * ctx.prefills / tr.window_s \
        / peaks.PEAK_BF16_FLOP_PER_S
