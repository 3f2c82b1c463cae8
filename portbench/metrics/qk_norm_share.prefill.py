"""qk_norm_share.prefill: the share of device time that OLMoE's QK-norm
takes: the operations launched inside the program's ``attn.qk_norm`` span
(the RMSNorms of the whole q and k projections, before RoPE), over all
device time of the host trace's prefills.  Read from the host trace
(``lib/spans.py``); nothing is read where the program records no
``attn.qk_norm`` span."""
from portbench.lib import spans

QK_NORM = "attn.qk_norm"


def read(ctx):
    found = spans.attribute(ctx.host)
    if found is None or not any(name == QK_NORM for _, name in found):
        return None
    total = sum(op.end - op.start for op, _ in found)
    inside = sum(op.end - op.start for op, name in found if name == QK_NORM)
    return inside / total if total > 0 else None
