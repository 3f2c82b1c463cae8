"""moe_expert_row_use.prefill: the share of the MoE experts' computed rows
that carry a routed (token, expert) pair: the program's counters
(``repro_torch.spans.counts()``: ``moe.routed``, tokens x top-k, over
``moe.computed``, the rows the grouped matmuls run, E x capacity a
buffer), summed over every MoE FFN call of the run.  Every prefill of a
cell has one shape, so this is each prefill's share: about 1 / capacity
factor, as the capacity is ceil(tokens x top-k x factor / E).  Nothing is
read where the program has no such counter or ran no MoE FFN."""


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    counted = spans.counts()
    computed = counted.get("moe.computed", 0)
    if computed <= 0:
        return None
    return counted["moe.routed"] / computed
