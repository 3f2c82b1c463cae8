"""ssm_glue_share.prefill: the share of device time in the Mamba2 mixer's
glue: the operations launched inside the program's ``ssm`` span or its
children (``ssm.conv``, ``ssm.scan``, ``ssm.gate_norm``) that are glue as
``glue_share.prefill`` counts it (neither cuBLAS by name nor a kernel
launched from outside every PyTorch operator) and no SSD kernel
(``ssd_scan_roofline.prefill``'s names), over all device time of the host
trace's prefills: the causal conv, the SSD's layout copies, dt's softplus,
the D term, the casts and the gated norm.  Read from the host trace
(``lib/spans.py``); nothing is read where the program records no ``ssm``
span."""
from portbench.lib import spans
from portbench.lib.spec import metric_reader

GLUE = metric_reader("glue_share.prefill")
SSD = metric_reader("ssd_scan_roofline.prefill")


def is_glue(op) -> bool:
    return not GLUE.is_matmul(op) and (op.kind != "kernel" or op.in_aten) \
        and not any(k in op.name for k in SSD.KERNELS)


def read(ctx):
    found = spans.attribute(ctx.host)
    if found is None or not any(spans.in_family(name, "ssm")
                                for _, name in found):
        return None
    total = sum(op.end - op.start for op, _ in found)
    glue = sum(op.end - op.start for op, name in found
               if spans.in_family(name, "ssm") and is_glue(op))
    return glue / total if total > 0 else None
