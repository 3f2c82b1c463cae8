"""The model code's operations that DTensor cannot shard by itself, done
shard-locally on a ``DeviceMesh``.

The model modules call these whatever their operands: each helper returns
the plain computation for plain tensors (off a mesh), so a call site is one
line either way, and only this module reads placements.  For DTensor
operands each says where its math is shard-local and which collective it
adds:

* ``sharded_embed`` — the embedding gather and its fixed-order backward
  (``layers._Embed``: a stable sort and ``unique_consecutive``, which have
  no sharding strategy), vocab-parallel: each rank gathers the rows of its
  own vocab shard (a partial sum over the vocab's mesh dims, other rows
  zero), its d_model shards are gathered only over mesh dims that also
  shard the tokens, and the table's gradient is the sum over the ranks
  that hold other tokens.  Gathering the whole table instead moved 2.4 GB
  per decode step on qwen2-72b.
* ``fsdp_gather`` — a weight all-gathered on use over the mesh dims that
  shard the tokens it meets (FSDP's gather, the choice XLA's partitioner
  makes for the reference's rules).  Left to itself DTensor's propagation
  gathers the activations over the batch instead (mamba2-370m train_4k:
  the tied head's (128, 4096, 50688) float32 logits whole on every rank).
* ``tp_dense`` — ``x @ w`` on each rank's own pieces (``local_map``), the
  Megatron layout read off the placements: per mesh dim, the tokens
  sharded (``w`` gathered there), the output columns sharded (column
  parallel, ``x`` whole) or the contraction sharded (row parallel, a
  partial sum).  Left to DTensor, the backward found the weight gradients'
  zero-communication strategy in whole, unsharded products on every rank
  of the model axis (16 times the flops on the production mesh).
* ``unshard_dim`` — a tensor gathered along one dim and its partial sums
  reduced, its other shards kept.  The cross entropy gathers the vocab of
  its logits with it and sums each rank's rows shard-locally: over
  vocab-sharded logits DTensor's ``gather`` strategy leaves a masked
  partial that the following subtraction cannot reduce, and its backward
  built the whole batch's (128, 4096, 50688) gradient on every rank.
* ``split_dim`` — one dim viewed as several ((..., n*hd) -> (..., n, hd),
  heads -> (KV heads, group)), the dim gathered first where its shards do
  not fall on the new boundaries (GQA's 8 KV heads on a model axis of
  16): DTensor cannot view an uneven split.
* ``shards_dim``, ``dim_shards`` and ``write_at`` — whether and how many
  ways a dim is split; the decode step's in-place cache write at ``pos``
  into a cache whose sequence is sharded: DTensor would gather the sharded
  dim to select from it, and the write would land in the gathered copy.
  The rank that holds ``pos`` writes its local shard.
* ``split_rows`` — the train step's microbatches: microbatch ``i`` is the
  ``i``-th contiguous block of rows, as in the reference, which reshards
  each block over the batch axes.  The rows are gathered along the batch
  dim (the batch's tokens: kilobytes per row), viewed as (n, rows / n) and
  sharded again on the second dim, so every rank holds its share of every
  microbatch and each microbatch holds the plain path's rows.  The
  microbatch losses are not linear in which rows a microbatch holds (the
  Switch aux loss, ``moe_ffn_flat``'s global capacity, the count of
  unmasked labels), so any other grouping would change the gradient.
* ``shard_local`` — a block whose math is local to each batch row and
  head (the SSD chunked scan and its decode step, the causal conv, the
  attention core in prefill and decode, the MoE routing, scatter and
  combine) run on each rank's own
  rows and heads (``local_map``): the heads stay sharded where every
  operand's head count divides their mesh dims, else they are gathered
  and the block runs whole on those ranks.  DTensor's own propagation
  through these blocks gathered activations over the batch in the
  backward, its per-operation dispatch is most of a traced step, and
  some releases refuse the batched products' folds of two sharded dims
  or fail on a padded sharded tensor.
* ``rank_offsets`` — per rank, the sum of a per-row count over the rows
  of the ranks before it (an all-gather of one count vector per rank):
  ``moe_ffn_flat``'s global running count of each expert's picks, taken
  per rank and offset, gives the reference's positions exactly.
* ``split_columns`` — a column-sharded weight cut into column pieces,
  each sharded again as the whole was where its width divides the shards
  (the SSM's fused in-projection: splitting its output would gather the
  activations, splitting the weight gathers the weight, as FSDP does).
* ``replicate`` and ``like`` — the train step's loss made whole on every
  rank before its backward is seeded (a seed filled into a partial sum
  would count once per rank), and each gradient laid out as its parameter
  (a reduce-scatter of the partial sums autograd leaves), so AdamW's
  elementwise update is shard-local.
"""
from __future__ import annotations

import math

import torch

__all__ = ["is_dtensor", "sharded_embed", "fsdp_gather", "tp_dense",
           "unshard_dim", "split_dim", "shards_dim", "dim_shards", "write_at",
           "split_rows", "shard_local", "rank_offsets", "split_columns",
           "replicate", "like"]


def is_dtensor(x) -> bool:
    """``x`` is a ``DTensor`` (without importing torch.distributed for a
    plain tensor)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor is replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_embed(embed_fn, table, tokens):
    """``embed_fn(table, tokens)`` (rows of the table at the tokens, with
    its own backward) for a DTensor ``table`` (V, D); per mesh dim the
    output is sharded as the tokens are, a partial sum where the vocab is
    split (over more than one rank), or split on D as the table is."""
    if not is_dtensor(table):
        return embed_fn(table, tokens.long())
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    nd = tokens.ndim + 1
    vmesh = [i for i in _mesh_dims_sharding(table, 0) if mesh.size(i) > 1]
    tab, tok, out, tab_g = [], [], [], []
    for i, (p, q) in enumerate(zip(table.placements, tokens.placements)):
        if i in vmesh:                       # vocab split: masked gather
            tab.append(p), tok.append(Replicate()), out.append(Partial())
            tab_g.append(p)
        elif isinstance(q, Shard):           # tokens split: table whole here
            tab.append(Replicate()), tok.append(q), out.append(q)
            tab_g.append(Partial())
        elif p.is_shard(1):                  # d_model split
            tab.append(p), tok.append(Replicate()), out.append(Shard(nd - 1))
            tab_g.append(p)
        else:
            tab.append(Replicate()), tok.append(Replicate())
            out.append(Replicate()), tab_g.append(Replicate())

    def local(t, i):
        i = i.long()
        if not vmesh:
            return embed_fn(t, i)
        lo, rows = 0, t.shape[0]
        for d in vmesh:                      # this rank's vocab rows
            lo = lo * mesh.size(d) + mesh.get_local_rank(d)
        lo *= rows
        inside = (i >= lo) & (i < lo + rows)
        rows_out = embed_fn(t, torch.where(inside, i - lo, 0))
        return rows_out * inside[..., None].to(rows_out.dtype)

    fn = local_map(local, out_placements=out,
                   in_placements=(tuple(tab), tuple(tok)),
                   in_grad_placements=(tuple(tab_g), tuple(tok)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(table, tokens)


def unshard_dim(x, dim: int):
    """DTensor ``x`` redistributed so that no mesh dim shards its ``dim``
    (an all-gather along it) and no partial sum is left (reduced); its
    other shards are kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    placements = tuple(p if isinstance(p, Shard) and p.dim != dim
                       else (p if p.is_replicate() else Replicate())
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def replicate(x):
    """``x`` whole on every rank (``Replicate`` on each mesh dim); a plain
    tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def like(x, ref):
    """DTensor ``x`` laid out as DTensor ``ref``; a plain ``x`` as it is."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with its ``dim`` viewed as ``sizes`` (e.g. (..., n*hd) ->
    (..., n, hd)); a DTensor whose ``dim`` is sharded into pieces that the
    first of ``sizes`` does not divide is gathered along it first."""
    dim = dim % x.ndim
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if sizes[0] % dim_shards(x, dim):
        x = unshard_dim(x, dim)
    return x.reshape(shape)


def _mesh_dims_sharding(x, dim: int) -> list:
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def shards_dim(x, dim: int) -> bool:
    """``x`` is a DTensor whose ``dim`` is split over a mesh dim of more
    than one rank."""
    return is_dtensor(x) and any(x.device_mesh.size(i) > 1
                                 for i in _mesh_dims_sharding(x, dim))


def dim_shards(x, dim: int) -> int:
    """The number of pieces ``x``'s ``dim`` is split into (1 for a plain
    tensor)."""
    if not is_dtensor(x):
        return 1
    return math.prod(x.device_mesh.size(i) for i in _mesh_dims_sharding(x, dim))


def write_at(buf, dim: int, index: int, value) -> None:
    """``buf.select(dim, index).copy_(value)`` for a DTensor ``buf`` whose
    ``dim`` is sharded: ``value`` (``buf`` without ``dim``) is laid out as
    ``buf``'s other dims and written into the local shard of the rank
    that holds ``index``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    placements = []
    for p in buf.placements:
        if not isinstance(p, Shard) or p.dim == dim:
            placements.append(Replicate())
        else:
            placements.append(Shard(p.dim - (p.dim > dim)))
    value = _as_dtensor(value, mesh)
    if tuple(value.placements) != tuple(placements):
        value = value.redistribute(mesh, placements)
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo = offset[dim]
    if lo <= index < lo + shape[dim]:
        buf.to_local().select(dim, index - lo).copy_(value.to_local())


def split_rows(x, axis: int, n: int):
    """``x`` with its ``axis`` viewed as (n, size / n): block ``i`` holds
    rows ``i * size / n`` up to ``(i + 1) * size / n``.  For a DTensor the
    rows are gathered along ``axis`` first and the (size / n) dim is then
    sharded as ``axis`` was, so each rank holds its share of every block."""
    shape = tuple(x.shape)
    shape = shape[:axis] + (n, shape[axis] // n) + shape[axis + 1:]
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Shard

    placements = tuple(Shard(p.dim + 1) if isinstance(p, Shard)
                       and p.dim >= axis else p for p in x.placements)
    whole = unshard_dim(x, axis).reshape(shape)
    return whole.redistribute(x.device_mesh, placements)


def fsdp_gather(w, x, token_dims):
    """DTensor weight ``w`` with every shard on a mesh dim that shards one
    of ``x``'s ``token_dims`` replicated (an all-gather of those shards);
    ``w`` itself where there is none (or ``x`` is plain)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return w
    dims = {d % x.ndim for d in token_dims}
    placements = tuple(
        Replicate() if isinstance(p, Shard) and isinstance(q, Shard)
        and q.dim in dims else p
        for p, q in zip(w.placements, x.placements))
    if placements == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


def shard_local(fn, args, dims, out_dims, heads_from: int = 0):
    """``fn(*args)``; for a DTensor ``args[0]``, run on each rank's local
    rows and heads.  ``dims[i]`` is ``(batch dim, head dim)`` of
    ``args[i]``, either ``None`` where it has none (``None`` for an
    argument that is not a DTensor); ``out_dims`` the same per output
    (``fn`` returns a tuple of several, or one), or ``"sum"`` for an
    output that is a partial sum over the ranks.  The mesh dims that shard
    ``args[0]``'s batch dim shard every batch dim; those that shard the
    head dim of ``args[heads_from]`` shard every head dim, if every head
    count divides them, else the heads are gathered (``heads_from`` names
    a weight where the heads arrive gathered but the weight shards them:
    the SSM's head vectors).  An operand without the dim is replicated
    there, and its gradient summed over those ranks."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ref = args[0]
    mesh = ref.device_mesh
    b0 = dims[0][0]
    h0 = dims[heads_from][1]
    bmesh = set(_mesh_dims_sharding(ref, b0))
    hmesh = set() if h0 is None else \
        set(_mesh_dims_sharding(args[heads_from], h0)) - bmesh
    k = 1
    for i in hmesh:
        k *= mesh.size(i)
    if any(d is not None and d[1] is not None and a.shape[d[1]] % k
           for a, d in zip(args, dims)):
        hmesh = set()

    def place(d, grad=False):
        if d is None:
            return None
        if d == "sum":
            return tuple(Partial() if i in bmesh or i in hmesh else Replicate()
                         for i in range(mesh.ndim))
        bd, hd = d
        out = []
        for i in range(mesh.ndim):
            own = bd if i in bmesh else hd if i in hmesh else None
            if own is not None:
                out.append(Shard(own))
            elif (i in bmesh or i in hmesh) and grad:
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)

    outs = [list(place(d)) for d in out_dims]
    wrapped = local_map(
        fn, out_placements=outs[0] if len(outs) == 1 else tuple(outs),
        in_placements=tuple(place(d) for d in dims),
        in_grad_placements=tuple(place(d, grad=True) for d in dims),
        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)


def rank_offsets(count, x):
    """For a DTensor ``x`` whose rows (dim 0) are split over the ranks, the
    sum of ``count`` (a function of a block of rows returning a vector,
    summed exactly: integers) over the rows of the ranks before each rank,
    one row per rank, laid out so that ``shard_local`` hands each rank its
    own; ``None`` for a plain ``x`` (no rows before it)."""
    if not is_dtensor(x):
        return None
    per_rank = shard_local(lambda xl: count(xl)[None], (x,), ((0, None),),
                           ((0, None),))
    whole = replicate(per_rank)
    return like(torch.cumsum(whole, dim=0) - whole, per_rank)


def split_columns(w, sizes):
    """DTensor ``w`` (K, N) cut into column pieces of ``sizes``; each piece
    is sharded on its columns over the mesh dims that shard ``w``'s where
    its width divides them, replicated there otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    cols = _mesh_dims_sharding(w, 1)
    k = dim_shards(w, 1)
    whole = unshard_dim(w, 1)
    out = []
    for piece in torch.split(whole, list(sizes), dim=1):
        if cols and piece.shape[1] % k == 0:
            piece = piece.redistribute(mesh, tuple(
                Shard(1) if i in cols else q
                for i, q in enumerate(whole.placements)))
        out.append(piece)
    return out


def tp_dense(x, w):
    """``x (..., K) @ w (K, N)`` for DTensors, the product of each rank's
    local pieces, with ``x``'s leading dims folded into one (as
    ``layers.dense``).  Per mesh dim: where ``x`` shards a leading dim,
    ``w`` must be whole there (``fsdp_gather``) and the output is sharded
    as ``x``; else where ``w`` shards N, ``x`` is gathered and the output
    sharded on N; where ``w`` shards K, ``x`` is sharded on K and the
    output is a partial sum; else both are whole.  Plain operands (or a
    plain ``x``) make one product."""
    def local(xl, wl):
        return (xl.reshape(-1, xl.shape[-1]) @ wl).reshape(
            *xl.shape[:-1], wl.shape[-1])

    if not (is_dtensor(x) and is_dtensor(w)):
        return local(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    last = x.ndim - 1
    xp, wp, op, xg, wg = [], [], [], [], []
    for q, r in zip(x.placements, w.placements):
        if isinstance(q, Shard) and q.dim != last and r.is_replicate():
            xp.append(q), wp.append(Replicate()), op.append(q)
            xg.append(q), wg.append(Partial())
        elif r.is_shard(1):
            xp.append(Replicate()), wp.append(r), op.append(Shard(last))
            xg.append(Partial()), wg.append(r)
        elif r.is_shard(0):
            xp.append(Shard(last)), wp.append(r), op.append(Partial())
            xg.append(Shard(last)), wg.append(r)
        else:
            xp.append(Replicate()), wp.append(Replicate())
            op.append(Replicate())
            xg.append(Replicate()), wg.append(Replicate())

    return local_map(local, out_placements=op, in_placements=(tuple(xp), tuple(wp)),
                     in_grad_placements=(tuple(xg), tuple(wg)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)
