"""kernel_launches.prefill: device operations (kernels, copies, memsets) per
prefill in the traced window, an exact count that fusions lower."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return ctx.trace.count() / ctx.prefills
