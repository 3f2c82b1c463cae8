"""device_idle_share.prefill: the share of the traced window in which no
operation ran on the card, 1 - (union of device intervals) / window."""


def read(ctx):
    tr = ctx.trace
    if not tr.ops or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
