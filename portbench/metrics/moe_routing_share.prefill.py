"""moe_routing_share.prefill: the share of device time that the MoE FFN's
routing machinery takes: the operations launched inside the program's
``moe.router``, ``moe.dispatch`` and ``moe.combine`` spans (the float32
router product, softmax and top-k; the slots, the zeroed buffer, the
scatter and the layout copy into the experts' rows; the copy back, the
gather and the gate multiply-adds), over all device time of the host
trace's prefills.  Read from the host trace (``lib/spans.py``); nothing is
read where the program records no ``moe`` span."""
from portbench.lib import spans

ROUTING = ("moe.router", "moe.dispatch", "moe.combine")


def read(ctx):
    found = spans.attribute(ctx.host)
    if found is None or not any(spans.in_family(name, "moe")
                                for _, name in found):
        return None
    total = sum(op.end - op.start for op, _ in found)
    routing = sum(op.end - op.start for op, name in found if name in ROUTING)
    return routing / total if total > 0 else None
