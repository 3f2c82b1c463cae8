"""glue_share.prefill: the share of device time in the port's glue, the
device operations that are neither matrix products (cuBLAS, by name) nor
kernels of the port's own.  A kernel is the port's own when its launch came
from outside every PyTorch operator (a ``ctypes`` or Triton launch); every
copy, memset and kernel launched from inside an operator that is not a
matrix product is glue.  Read from the host trace, which records where
each kernel was launched; nothing is read when a kernel's launch is not in
it."""

MATMUL = ("gemm", "nvjet", "cutlass", "xmma", "gemv")


def is_matmul(op) -> bool:
    name = op.name.lower()
    return any(p in name for p in MATMUL)


def read(ctx):
    tr = ctx.host
    if not tr.ops or any(o.kind == "kernel" and o.in_aten is None
                         for o in tr.ops):
        return None
    total = tr.seconds()
    glue = tr.seconds(lambda o: not is_matmul(o)
                      and (o.kind != "kernel" or o.in_aten))
    return glue / total if total > 0 else None
