"""shared_block_share.prefill: the share of device time that the published
Zamba2's shared blocks take: the operations launched inside the program's
``shared`` span (one call of a shared block: the concat, both norms, the
call's projection) or its ``shared.mlp`` (gate/up, the LoRA term, the GELU
product, down), or inside ``attn`` and ``attn.flash`` (all of such a
model's attention lies in its shared blocks), over all device time of the
host trace's prefills.  Read from the host trace (``lib/spans.py``);
nothing is read where the program records no ``shared`` span."""
from portbench.lib import spans

SHARED = ("shared", "shared.mlp", "attn", "attn.flash")


def read(ctx):
    found = spans.attribute(ctx.host)
    if found is None or not any(name == "shared" for _, name in found):
        return None
    total = sum(op.end - op.start for op, _ in found)
    inside = sum(op.end - op.start for op, name in found if name in SHARED)
    return inside / total if total > 0 else None
