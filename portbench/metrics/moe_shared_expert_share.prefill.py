"""moe_shared_expert_share.prefill: the share of device time that the MoE
FFN's shared expert takes: the operations launched inside the program's
``moe.shared_expert`` span (the always-on SwiGLU's three products and its
gate over every token), over all device time of the host trace's
prefills.  Read from the host trace (``lib/spans.py``); nothing is read
where the program records no ``moe.shared_expert`` span."""
from portbench.lib import spans

SHARED_EXPERT = "moe.shared_expert"


def read(ctx):
    found = spans.attribute(ctx.host)
    if found is None or not any(name == SHARED_EXPERT for _, name in found):
        return None
    total = sum(op.end - op.start for op, _ in found)
    inside = sum(op.end - op.start for op, name in found
                 if name == SHARED_EXPERT)
    return inside / total if total > 0 else None
