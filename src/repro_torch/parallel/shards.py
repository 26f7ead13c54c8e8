"""What the models need to run on DTensors: layouts by role, and a function
run on each rank's shards.

A model tensor is sharded over a mesh dim by one of its roles: its batch
dim, its head dim (attention and Mamba heads under tensor parallelism), or
its group or expert dim (the MoE's dispatch).  ``roles`` reads, for each
mesh dim, which role a DTensor is sharded by; ``layout`` gives the
placements of another tensor that has those roles at its own dims; and
``on_shards`` runs a function of plain tensors on each rank's shards (as
``local_map`` does, uneven shards included), for work that is independent
across the sharded roles (the attention of one (batch, head), the SSD scan
of one head, the dispatch of one group) and whose tensors are made from
local shapes.  ``tp_matmul`` is
every dense product of an activation and a weight, run on the shards the
reference's layout gives it, ``nll_sum`` the cross-entropy of each
rank's rows of logits, whole or split over the vocab, and ``local_shape`` a
DTensor's shard shape from its global shape alone.  On plain tensors every
helper is the identity, or calls the function as it is.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \
    distribute_tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.tree import tree_map

__all__ = ["is_dtensor", "mesh_of", "roles", "head_roles", "layout",
           "on_shards", "tp_matmul", "nll_sum", "local_shape",
           "mergeable_rows", "merge_rows", "split_rows", "replicate_like",
           "batch_like", "match", "gather_dim", "gather_fsdp", "group_over",
           "relayout", "sum_of_squares"]


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def mesh_of(*ts):
    """The mesh of the first DTensor among ``ts``, or None."""
    for t in ts:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def roles(t: DTensor, **dims) -> tuple:
    """For each mesh dim, the role (a key of ``dims``, whose value is a dim
    of ``t``) that ``t`` is sharded by there, or None."""
    by_dim = {d: r for r, d in dims.items() if d is not None}
    return tuple(by_dim.get(p.dim) if isinstance(p, Shard) else None
                 for p in t.placements)


def head_roles(t: DTensor, head_dim: int, n_heads: int,
               n_groups: int | None = None) -> tuple:
    """For each mesh dim, "batch" or "heads" where the DTensor ``t`` (the
    batch at dim 0, the heads at ``head_dim``) is sharded by them (the
    heads only where they split evenly; the batch as it lies, evenly or
    not, ``on_shards`` giving each rank its rows); None (replicated in the
    per-head work) elsewhere.
    ``n_groups`` counts a second head-like dim whose tensors shard with the
    heads (attention's kv heads, Mamba's B/C groups), so the heads stay
    sharded only where it splits evenly too; None when every head reads
    the same replicated tensors (a single B/C group)."""
    mesh = t.device_mesh
    out = []
    for m, role in enumerate(roles(t, batch=0, heads=head_dim)):
        n = mesh.size(m)
        if role == "heads" and (n_heads % n or (n_groups is not None
                                                and n_groups % n)):
            role = None
        out.append(role)
    return tuple(out)


def layout(mesh_roles: tuple, **dims) -> tuple:
    """Placements of a tensor whose role ``r`` lies at dim ``dims[r]`` (a
    role it lacks, or maps to None, is replicated) on a mesh whose dims are
    sharded by ``mesh_roles``."""
    return tuple(Shard(dims[r]) if dims.get(r) is not None else Replicate()
                 for r in mesh_roles)


def on_shards(fn, mesh, args: tuple, in_placements: tuple,
              out_placements):
    """``fn(*local args)`` on each rank's shard of every DTensor in ``args``
    (each first laid out as ``in_placements`` says; None for a non-tensor),
    its outputs made DTensors laid out as ``out_placements`` says: a tuple
    with one entry an output (``(pl,)`` for a single output; None for a
    function that returns None).  Without a DTensor among ``args`` it is
    ``fn(*args)``.

    ``local_map``'s steps, but for the outputs' global shapes: a shard may
    be uneven (a batch of fewer rows than the ranks that split it, as
    ``torch.chunk`` splits it: some ranks hold no row), so an output's dim
    takes the global size of an input's dim split over the same mesh dims
    with the same local size (``_global_shape``), not its local size times
    the ranks.

    Gradients: where some input is sharded over a mesh dim, the ranks along
    it run ``fn`` on different shards, so the gradient of an input that is
    replicated there (a weight, or B/C read by every head) holds only this
    rank's share: it is taken as partial sums over that mesh dim."""
    if mesh is None:
        return fn(*args)
    split = [any(pl is not None and isinstance(pl[m], Shard)
                 for pl in in_placements) for m in range(mesh.ndim)]
    local, boxes = [], []
    for a, pl in zip(args, in_placements):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        pl = tuple(pl)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        grad_pl = tuple(Partial() if split[m] and isinstance(p, Replicate)
                        else p for m, p in enumerate(pl))
        t = a.to_local(grad_placements=grad_pl)
        if isinstance(t, AsyncCollectiveTensor):
            t = t.wait()
        boxes.append((tuple(a.shape), _split_by(pl, a.dim()), tuple(t.shape)))
        local.append(t)
    if not boxes:
        return fn(*args)
    out = fn(*local)
    flat, spec = tree_flatten(out)
    outs = out_placements if isinstance(out_placements, tuple) \
        else (out_placements,)
    if len(flat) != len(outs):
        raise ValueError(f"{len(flat)} outputs for {len(outs)} "
                         "out_placements")
    wrapped = []
    for t, pl in zip(flat, outs):
        if not isinstance(t, torch.Tensor):
            wrapped.append(t)
            continue
        pl = tuple(pl)
        shape, even = _global_shape(t, pl, mesh, boxes)
        wrapped.append(DTensor.from_local(t, mesh, pl, run_check=False)
                       if even else DTensor.from_local(
                           t, mesh, pl, run_check=False, shape=shape,
                           stride=_contiguous_stride(t, shape)))
    return tree_unflatten(wrapped, spec)


def _split_by(pl: tuple, ndim: int) -> dict:
    """Tensor dim -> the mesh dims (in order) whose ``Shard`` splits it."""
    out: dict = {}
    for m, p in enumerate(pl):
        if isinstance(p, Shard):
            out.setdefault(p.dim % ndim, []).append(m)
    return {d: tuple(ms) for d, ms in out.items()}


def _global_shape(t: torch.Tensor, pl: tuple, mesh, boxes: list) -> tuple:
    """(global shape, whether it is the even one) of the output shard ``t``
    laid out as ``pl``: each split dim takes the global size of the first
    input dim (``boxes``: global shape, split dims, local shape) split over
    the same mesh dims with the same local size, else its local size times
    those dims' ranks (an even split, ``DTensor.from_local``'s own rule).
    Refused where that shape's shard on this rank (``local_shape``) is not
    ``t``'s."""
    shape = list(t.shape)
    for d, ms in _split_by(pl, t.dim()).items():
        shape[d] = t.shape[d] * math.prod(mesh.size(m) for m in ms)
    even = tuple(shape)
    for d, ms in _split_by(pl, t.dim()).items():
        for gshape, by, lshape in boxes:
            hit = [d2 for d2, ms2 in by.items()
                   if ms2 == ms and lshape[d2] == t.shape[d]]
            if hit:
                shape[d] = gshape[hit[0]]
                break
    shape = tuple(shape)
    if local_shape(shape, mesh, pl) != tuple(t.shape):
        raise ValueError(f"no global shape of a {tuple(t.shape)} shard laid "
                         f"out as {pl} follows from the inputs")
    return shape, shape == even


def _contiguous_stride(t: torch.Tensor, shape: tuple) -> tuple:
    """Strides of a tensor of ``shape`` whose dims lie in memory in the
    order of ``t``'s (outermost first), without gaps."""
    order = sorted(range(t.dim()), key=lambda i: (-t.stride(i), i))
    stride, step = [0] * t.dim(), 1
    for i in reversed(order):
        stride[i] = step
        step *= max(shape[i], 1)
    return tuple(stride)


def tp_matmul(x, w):
    """``x @ w`` for an activation ``x`` (..., rows, k) and a weight ``w``
    (k, n), or a stack of them (E, k, n) against ``x`` (E, rows, k), on the
    shards the weight's own placements give each rank, whatever torch's
    DTensor would choose.  The parameter layout (``parallel.param_specs``,
    the reference's ``src/repro/parallel/sharding.py``) decides which dim
    the mesh dim 'model' splits: n (``wi``, ``wg``, ``wq``/``wk``/``wv``,
    the Mamba in-projections, an lm head over its vocab) or k (``wo``,
    ``out_proj``, an lm head over d); a weight it leaves whole is
    multiplied whole, and one split over 'model' on a stack's leading dim
    is refused.

    Each mesh dim follows the weight's placement there, which is left as it
    arrives ('data' as ``gather_fsdp`` leaves an FSDP weight): where it
    splits n, x is whole there and each rank computes its columns; where it
    splits k, each rank multiplies its slice of x's last dim and the
    product holds partial sums, reduced at once onto x's rows as they
    arrived (Megatron's all-reduce after a row-parallel product, a
    reduce-scatter where the rows were split there); where it splits a
    stack's leading dim, x is split there too; where it is replicated, x's
    rows keep their split (the batch's, ``_pin_batch``'s rule) and anything
    else of x there is gathered.  The gradients follow ``on_shards``' rule.
    On plain tensors it is ``x @ w``."""
    mesh = mesh_of(x, w)
    if mesh is None:
        return x @ w
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        raise ValueError("tp_matmul takes both operands as DTensors or "
                         "neither")
    xd, wd = x.dim(), w.dim()
    k_x, k_w, n_w = xd - 1, wd - 2, wd - 1
    stack = range(xd - wd, xd - 2)            # x's dims facing w's stack
    names = mesh.mesh_dim_names or (None,) * mesh.ndim
    x_in, out, final = [], [], []
    for m, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if wp.is_partial():
            raise ValueError("a weight held as partial sums")
        rows = xp if isinstance(xp, Shard) and xp.dim % xd < k_x \
            and xp.dim % xd not in stack else Replicate()
        if not isinstance(wp, Shard):
            x_in.append(rows)
            out.append(rows)
        elif wp.dim % wd == k_w:
            x_in.append(Shard(k_x))
            out.append(Partial())
        elif wp.dim % wd == n_w:
            x_in.append(Replicate())
            out.append(Shard(xd - 1))
        elif names[m] == "model":
            raise ValueError(f"'model' splits the stack dim {wp.dim} of a "
                             f"{wd}-dim weight")
        else:                                  # a stack's leading dim
            x_in.append(Shard(wp.dim % wd + xd - wd))
            out.append(x_in[-1])
        final.append(rows if out[-1].is_partial() else out[-1])
    y = on_shards(torch.matmul, mesh, (x, w),
                  (tuple(x_in), tuple(w.placements)), (tuple(out),))
    if final != out:
        y = y.redistribute(mesh, final)
    return y


def _plain_nll_sum(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(
        logits, torch.clamp(labels, min=0).long()[..., None], dim=-1)[..., 0]
    return torch.where(labels >= 0, lse - tgt, 0.0).sum()


class _SplitNll(torch.autograd.Function):
    """``_plain_nll_sum`` of rows whose vocab is split over the process
    groups ``groups``: this rank holds the columns from ``offset`` on.  The
    forward all-reduces each row's maximum (with max), then its
    ``sum(exp(logit - max))`` and its target logit, which only the rank
    holding the label's column contributes (with sum), so every rank of
    the groups returns the same sum.  The backward needs no collective:
    with the row's logsumexp whole after the forward, this rank's share of
    the gradient is its columns' softmax less the label's one-hot, times
    the mask.  A Function, not DTensor reductions under ``local_map``'s
    gradient placements: its collectives are issued here, so they do not
    depend on how a torch version's DTensor propagates a maximum or a
    partial sum, and its backward makes one float32 copy of the shard."""

    @staticmethod
    def forward(ctx, logits, labels, offset: int, groups: tuple):
        n_cols = logits.shape[-1]
        m = logits.amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
        col = labels.long() - offset
        hit = (col >= 0) & (col < n_cols)
        col = col.clamp(0, n_cols - 1)
        tgt = torch.take_along_dim(logits, col[..., None], dim=-1)[..., 0]
        parts = torch.stack([(logits - m[..., None]).exp_().sum(dim=-1),
                             torch.where(hit, tgt, 0.0)])
        for g in groups:
            dist.all_reduce(parts, dist.ReduceOp.SUM, group=g)
        lse = m + torch.log(parts[0])
        valid = labels >= 0
        ctx.save_for_backward(logits, lse, col, hit & valid, valid)
        return torch.where(valid, lse - parts[1], 0.0).sum()

    @staticmethod
    def backward(ctx, grad):
        logits, lse, col, hit, valid = ctx.saved_tensors
        out = (logits - lse[..., None]).exp_()
        out.scatter_add_(-1, col[..., None], -hit.to(out.dtype)[..., None])
        out.mul_((grad * valid)[..., None])
        return out, None, None, None


def nll_sum(logits, labels):
    """The summed cross-entropy of ``logits`` (..., V) against ``labels``
    (...): ``logsumexp(row) - row[label]`` over the rows whose label is
    >= 0.  On plain tensors: ``logsumexp``, ``take_along_dim`` and a
    masked sum.

    On DTensors each rank computes on its own rows (under ``on_shards``)
    and the sum comes out as partial sums over the mesh dims that split the
    rows, replicated elsewhere: no op, forward or backward, makes a tensor
    of more rows than the rank's share (DTensor's ``take_along_dim``
    backward makes a replicated, whole-batch zero tensor at the full
    vocab).  Logits whole over the vocab (a replicated head, or one split
    on d: ``tp_matmul`` has reduced its partial sums, and ``gather_dim``
    reduces any that are left) take the plain computation on each rank's
    rows.  Logits split over the vocab (a head split on V) stay split:
    ``_SplitNll`` combines each row's maximum, exponential sum and target
    over the mesh dims that split it.  A mesh dim of size 1 splits
    nothing, so at world size 1 the result is the plain one, bit for
    bit."""
    mesh = mesh_of(logits)
    if mesh is None:
        return _plain_nll_sum(logits, labels)
    last = logits.dim() - 1
    split = {m: p.dim % logits.dim() for m, p in enumerate(logits.placements)
             if isinstance(p, Shard) and mesh.size(m) > 1}
    vocab = [m for m, dim in split.items() if dim == last]
    rows = [m for m, dim in split.items() if dim != last]
    if not vocab:
        logits = gather_dim(logits, -1)
    pl = tuple(logits.placements)
    lab_pl = tuple(pl[m] if m in rows else Replicate()
                   for m in range(mesh.ndim))
    out_pl = tuple(Partial() if m in rows else Replicate()
                   for m in range(mesh.ndim))
    if vocab:
        offset = _shard_box(logits.shape, mesh, pl)[1][last]
        groups = tuple(mesh.get_group(m) for m in vocab)

        def fn(lg, lb):
            return _SplitNll.apply(lg, lb, offset, groups)
    else:
        fn = _plain_nll_sum
    return on_shards(fn, mesh, (logits, labels), (pl, lab_pl), (out_pl,))


def _shard_box(shape, mesh, placements) -> tuple:
    """(shape, offset): the shape of this rank's shard of a DTensor of
    global ``shape`` laid out on ``mesh`` as ``placements`` say, and where
    the shard starts in each dim.  DTensor's own rule, each ``Shard``
    splitting the dim as ``torch.chunk`` does (the first ranks take
    ``ceil(size / n)`` rows, the last may take fewer or none), mesh dims in
    order, so a dim split by two mesh dims is split again within the first
    one's chunk.  A rank outside the mesh holds nothing."""
    out, start = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    if coord is None:
        return (0,) * len(out), tuple(start)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, size = mesh.size(m), out[p.dim]
            full = -(-size // n)
            start[p.dim] += min(size, coord[m] * full)
            out[p.dim] = max(0, min(full, size - coord[m] * full))
    return tuple(out), tuple(start)


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of this rank's shard of a DTensor of global ``shape`` laid
    out on ``mesh`` as ``placements`` say, made from shapes alone
    (``_shard_box``'s rule)."""
    return _shard_box(shape, mesh, placements)[0]


def _inner_split(x) -> tuple | None:
    """(mesh dim, B rows of a block, the mesh dim's ranks) where the DTensor
    ``x`` (B, S, ...) has dim 0 alone split, over mesh dims of which the
    outer ones split B evenly into blocks and the last splits each block
    as ``torch.chunk`` does (evenly or not); None for any other layout."""
    by = _split_by(tuple(x.placements), x.dim())
    if set(by) != {0}:
        return None
    mesh, dims = x.device_mesh, by[0]
    outer = math.prod(mesh.size(m) for m in dims[:-1])
    if x.shape[0] % outer:
        return None
    return dims[-1], x.shape[0] // outer, mesh.size(dims[-1])


def mergeable_rows(x) -> bool:
    """Whether ``merge_rows`` takes the DTensor ``x``: dim 0 alone split,
    the outer mesh dims evenly, and each outer block's B·S rows dividing
    by the last mesh dim's ranks."""
    split = _inner_split(x)
    return split is not None and split[1] * x.shape[1] % split[2] == 0


def _row_exchange(local, mesh, dim: int, src: list, dst: list):
    """``local``'s rows (``src`` of this rank, (start, length) by rank of
    the mesh dim ``dim``) moved so that each of its ranks holds its ``dst``
    rows: one all-to-all over that mesh dim, differentiable (its backward
    is the reverse exchange)."""
    me = mesh.get_coordinate()[dim]

    def common(a, b):
        return max(0, min(a[0] + a[1], b[0] + b[1]) - max(a[0], b[0]))

    send = [common(src[me], d) for d in dst]
    recv = [common(r, dst[me]) for r in src]
    out = funcol.all_to_all_single_autograd(local, recv, send,
                                            mesh.get_group(dim))
    return out.wait() if isinstance(out, AsyncCollectiveTensor) else out


def _blocks(block: int, s: int, n: int) -> tuple:
    """(the last mesh dim's ranks' B·S rows within an outer block of
    ``block`` B rows split as ``torch.chunk`` splits B, the same rows split
    evenly)."""
    full = -(-block // n)
    uneven = [(min(block, c * full) * s,
               max(0, min(full, block - c * full)) * s) for c in range(n)]
    per = block * s // n
    return uneven, [(c * per, per) for c in range(n)]


def merge_rows(x):
    """A DTensor ``x`` (B, S, ...) that ``mergeable_rows`` takes (a batch
    pinned over mesh dims whose last splits it unevenly, as 16 rows over
    (pod 2, data 16)) as its (B·S, ...) rows split evenly over the same
    mesh dims: one all-to-all over the last of them gives every rank whole
    rows' pieces, no rank more than its share."""
    mesh, pl = x.device_mesh, tuple(x.placements)
    dim, block, n = _inner_split(x)
    s, rest = x.shape[1], tuple(x.shape[2:])
    local = x.to_local(grad_placements=pl)
    local = local.reshape((local.shape[0] * s,) + rest)
    out = _row_exchange(local, mesh, dim, *_blocks(block, s, n))
    shape = (x.shape[0] * s,) + rest
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(out, shape))


def split_rows(y, like):
    """``merge_rows``' inverse: the (B·S, ...) rows ``y`` as a (B, S, ...)
    DTensor laid out as ``like`` (the DTensor that was merged)."""
    mesh, pl = like.device_mesh, tuple(like.placements)
    dim, block, n = _inner_split(like)
    s, rest = like.shape[1], tuple(y.shape[1:])
    local = y.redistribute(mesh, pl).to_local(grad_placements=pl)
    uneven, even = _blocks(block, s, n)
    out = _row_exchange(local, mesh, dim, even, uneven)
    out = out.reshape((out.shape[0] // s, s) + rest)
    shape = (like.shape[0], s) + rest
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(out, shape))


def replicate_like(t: torch.Tensor, ref):
    """``t`` (the same on every rank) as a DTensor replicated over the mesh
    of ``ref`` when ``ref`` is one; else ``t``."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def batch_like(t: torch.Tensor, ref):
    """``t`` (the whole tensor, the same on every rank) laid out as ``ref``
    on the leading dims they share, replicated elsewhere: each rank keeps
    its own slice, with no collective.  ``t`` itself when ``ref`` is not a
    DTensor."""
    if not isinstance(ref, DTensor):
        return t
    pl = [p if isinstance(p, Shard) and p.dim < t.dim() else Replicate()
          for p in ref.placements]
    return distribute_tensor(t, ref.device_mesh, pl, src_data_rank=None)


def match(t, ref):
    """``t`` laid out as ``ref`` is, when both are DTensors."""
    if isinstance(t, DTensor) and isinstance(ref, DTensor) \
            and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def gather_dim(t, dim: int):
    """``t`` whole along ``dim`` on every rank (all-gathered where a mesh dim
    shards it, summed where it holds partial sums), its other placements
    kept, when it is a DTensor."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    pl = [Replicate() if p.is_partial()
          or (isinstance(p, Shard) and p.dim == dim) else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def gather_fsdp(tree, x):
    """The weights of ``tree`` for their products with the rows of ``x``:
    each DTensor that the mesh dim 'data' splits on one of its two matrix
    dims (FSDP; a leading expert dim split there stays split) is
    all-gathered over 'data', its other placements kept.  This is FSDP's
    gather before a layer, as the reference's layout intends (GSPMD
    all-gathers per layer).  Without it DTensor may contract an activation
    replicated over 'data' against the weight's shard there, leave the
    product as partial sums and reduce-scatter them onto the sequence dim,
    whose backward torch 2.11 refuses to flatten.  So under autograd every
    such weight is gathered; without it (prefill, decode) only where that
    moves fewer bytes than the partial sums would, when each of its
    matrices meets at least as many rows of ``x`` as it has input dims: a
    decode step's few rows keep the partial sums.  The gather's backward
    reduce-scatters the gradient back onto the shard.  Every other leaf is
    returned as it is."""
    grad = torch.is_grad_enabled() and x.requires_grad

    def one(w):
        if not isinstance(w, DTensor) or w.dim() < 2:
            return w
        names = w.device_mesh.mesh_dim_names or ()
        if "data" not in names:
            return w
        m = names.index("data")
        p = w.placements[m]
        if not isinstance(p, Shard) or p.dim < w.dim() - 2:
            return w
        rows = x.numel() // (x.shape[-1] * math.prod(w.shape[:-2]))
        if not grad and rows < w.shape[-2]:
            return w
        pl = list(w.placements)
        pl[m] = Replicate()
        return w.redistribute(w.device_mesh, pl)

    return tree_map(one, tree)


def group_over(mesh, dims: tuple):
    """The process group of this rank and the ranks that differ from it
    only along the mesh dims ``dims`` (those of one rank left out), ordered
    as a dim split over ``dims`` (in mesh order) orders its shards; None
    where no such group can be had here.  One dim is the mesh's own group,
    and every dim of a mesh that lists the world's ranks in order is the
    world's.  Others are made once a mesh, every group of them on every
    rank (as ``new_group`` asks), so only on a mesh that spans the world.
    The mesh is not flattened: DTensor would then gather over the
    flattened dims."""
    dims = tuple(m for m in sorted(dims) if mesh.size(m) > 1)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    if not dims or mesh.size() != dist.get_world_size():
        return None
    ranks = mesh.mesh
    if len(dims) == sum(mesh.size(m) > 1 for m in range(mesh.ndim)) \
            and ranks.reshape(-1).tolist() == list(range(mesh.size())):
        return dist.group.WORLD
    cache = mesh.__dict__.setdefault("_groups_over", {})
    if dims not in cache:
        rest = tuple(m for m in range(mesh.ndim) if m not in dims)
        n = math.prod(mesh.size(m) for m in dims)
        me = dist.get_rank()
        for row in ranks.permute(*rest, *dims).reshape(-1, n).tolist():
            group = dist.new_group(row)
            if me in row:
                cache[dims] = group
    return cache[dims]


def _sharded_by(pl: tuple, dim: int, mesh) -> tuple | None:
    """The mesh dims of more than one rank whose ``Shard`` splits ``dim``;
    None where one of them splits it in strides (``_StridedShard``), whose
    shards a flat collective does not order."""
    ms = tuple(m for m, p in enumerate(pl) if isinstance(p, Shard)
               and p.dim == dim and mesh.size(m) > 1)
    return ms if all(type(pl[m]) is Shard for m in ms) else None


def _collective(local, d: int, op: str, group, n: int):
    """``local`` reduce-scattered (``op`` "reduce_scatter") or all-gathered
    ("all_gather") along its dim ``d`` over ``group`` of ``n`` ranks."""
    x = local.movedim(d, 0).contiguous()
    ops = torch.ops._c10d_functional
    if op == "reduce_scatter":
        out = ops.reduce_scatter_tensor(x, "sum", n, group.group_name)
    else:
        out = ops.all_gather_into_tensor(x, n, group.group_name)
    return ops.wait_tensor(out).movedim(0, d)


def relayout(t, like):
    """``t`` laid out as ``like`` is, when both are DTensors, with one
    collective for each change that spans several mesh dims: the mesh dims
    on which ``t`` holds partial sums and ``like`` splits one tensor dim are
    reduce-scattered onto it together, and the mesh dims that split one
    tensor dim of ``t`` and that ``like`` replicates are all-gathered
    together (DTensor moves one mesh dim at a time, and all-reduces each
    partial sum where an op needs the whole tensor).  What is left (partial
    sums ``like`` replicates, other moves) is redistributed as DTensor does
    it, on the smaller tensor."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    mesh, dst = t.device_mesh, tuple(like.placements)
    for op in ("reduce_scatter", "all_gather"):
        src = tuple(t.placements)
        if op == "reduce_scatter":
            moved = tuple(m for m, (p, q) in enumerate(zip(src, dst))
                          if p.is_partial() and isinstance(q, Shard))
            by = dst
        else:
            moved = tuple(m for m, (p, q) in enumerate(zip(src, dst))
                          if isinstance(p, Shard) and isinstance(q, Replicate))
            by = src
        ms = tuple(m for m in moved if mesh.size(m) > 1)
        dims = {by[m].dim % t.dim() for m in ms}
        n = math.prod(mesh.size(m) for m in ms)
        if n == 1 or len(dims) != 1:
            continue
        d = dims.pop()
        local = t.to_local()
        if op == "reduce_scatter":
            # mesh dims after ``ms`` that ``like`` also splits ``d`` over
            # and ``t`` replicates take their slice of the shard locally
            inner = _sharded_by(dst, d, mesh) or ()
            fits = (_sharded_by(src, d, mesh) == () and inner[:len(ms)] == ms
                    and all(isinstance(src[m], Replicate)
                            for m in inner[len(ms):])
                    and local.shape[d] % n == 0)
        else:
            fits = (_sharded_by(src, d, mesh) == ms
                    and _sharded_by(dst, d, mesh) == ()
                    and local.shape[d] * n == t.shape[d])
        if not fits:
            continue
        group = group_over(mesh, ms)
        if group is None:
            continue
        out = _collective(local, d, op, group, n)
        pl = tuple(dst[m] if m in moved else p for m, p in enumerate(src))
        t = DTensor.from_local(out, mesh, pl, run_check=False, shape=t.shape,
                               stride=_contiguous_stride(out, t.shape))
    return match(t, like)


def sum_of_squares(leaves) -> torch.Tensor:
    """The float32 sum of every element's square over ``leaves``, DTensors
    among them, replicated: each rank sums its shards, leaf by leaf in
    order (a shard that other ranks hold too counts on one of them only),
    then one all-reduce over the whole mesh (one a mesh dim where
    ``group_over`` has no group for them all).  A leaf that holds partial
    sums is reduced first, as DTensor reduces it."""
    first = next(x for x in leaves if isinstance(x, DTensor))
    mesh = first.device_mesh
    coord = mesh.get_coordinate()
    parts = []
    for x in leaves:
        pl = tuple(x.placements) if isinstance(x, DTensor) else \
            (Replicate(),) * mesh.ndim
        if any(p.is_partial() for p in pl):
            pl = tuple(Replicate() if p.is_partial() else p for p in pl)
            x = x.redistribute(mesh, pl)
        local = x.to_local() if isinstance(x, DTensor) else x
        s = torch.sum(torch.square(local.float()))
        held = all(coord[m] == 0 for m, p in enumerate(pl)
                   if not isinstance(p, Shard))
        parts.append(s if held else torch.zeros_like(s))
    total = sum(parts)
    group = group_over(mesh, tuple(range(mesh.ndim)))
    ops = torch.ops._c10d_functional
    for g in [group] if group is not None else \
            [mesh.get_group(m) for m in range(mesh.ndim) if mesh.size(m) > 1]:
        total = ops.wait_tensor(ops.all_reduce(total, "sum", g.group_name))
    return DTensor.from_local(total, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)
