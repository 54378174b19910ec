"""Tensor parallelism over ``torch.distributed``: Megatron's regions.

The reference has no such module: GSPMD inserts its collectives from the
sharding rules.  The port does it by hand, in the regions of Megatron-LM
(Shoeybi et al.; sequence parallel from Korthikanti et al.), each a
``torch.autograd.Function`` over the tp group of the rules that
``core.sharding.axis_rules`` installs:

* :func:`copy_to_tp` (identity forward, all-reduce backward) before a
  column-parallel product, and :func:`reduce_from_tp` (all-reduce forward,
  identity backward) after a row-parallel one;
* under sequence parallel, :func:`gather_seq` (all-gather along S forward,
  reduce-scatter backward) before the column-parallel product and
  :func:`reduce_scatter_to_seq` (its transpose) after the row-parallel one;
  :func:`split` keeps this rank's slice of a whole tensor;
* :func:`vocab_embed` (ids outside this rank's rows masked, looked up,
  all-reduced) and :func:`vocab_cross_entropy` (max, sum of exp and the
  gold logit by the reference's mask-sum, each all-reduced; the backward is
  ``softmax - onehot`` on the local shard), and :func:`gather_vocab` for the
  logits a sampler reads;
* for heads that split a recurrent block (the SSD's, the xLSTM's):
  :func:`mine` (this rank's heads of a whole leaf), :func:`sum_sq` (a
  norm's statistic over a head-split width) and :func:`leave_cols` (this
  rank's channels back into the residual stream).

Every collective of the port goes through :func:`collective`, and every
point-to-point message (the pipeline's activations and their gradients)
through :func:`send` and :func:`recv`; they count
calls and bytes per kind in ``counts`` and ``nbytes`` (the bytes of the
whole tensor: the all-reduced one, the gathered output, the reduce-scattered
input), and per kind and group in ``by_group`` and ``bytes_by_group``
(keys ``"<kind>@<group>"``: the mesh axis of the group, ``pod,data`` for a
``(pod, data)`` plane, ``world`` for the default group; ``send@pp`` and
``recv@pp`` for the messages, with the bytes of the message); :func:`reset`
zeroes all four.  Over gloo, whose backend table lists ``send``/``recv`` for
CPU tensors only, a CUDA message goes through pinned host buffers that are
reused from pass to pass; over NCCL it is sent as it is.  A send is posted
and not waited (:func:`wait_sends` waits for them all), a receive is
waited.  Without installed rules, or with a tp axis one rank wide, every
region is the identity and nothing is called.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch.core import sharding

counts: collections.Counter = collections.Counter()
nbytes: collections.Counter = collections.Counter()
by_group: collections.Counter = collections.Counter()
bytes_by_group: collections.Counter = collections.Counter()
_group_names: dict = {}


def reset() -> None:
    """Zero every collective count."""
    for c in (counts, nbytes, by_group, bytes_by_group):
        c.clear()


def name_group(group, name: str) -> None:
    """Label ``group``'s collectives ``name`` in ``by_group`` (the mesh
    names the groups it creates)."""
    _group_names[id(group)] = name


def group_name(group) -> str:
    return "world" if group is None else _group_names.get(id(group), "other")

KINDS = ("all_reduce", "all_reduce_max", "all_gather", "reduce_scatter")


def axis_name(mesh) -> str:
    """The mesh axis that the logical "tp" resolves to."""
    return "tp" if "tp" in mesh.axis_names else sharding.AxisRules.ALIASES["tp"]


def group():
    """The installed mesh's tp process group (None without rules or on a tp
    axis one rank wide)."""
    r = sharding.installed()
    return None if r is None else r.mesh.groups[axis_name(r.mesh)]


def size() -> int:
    r = sharding.installed()
    return 1 if r is None else r.mesh.shape[axis_name(r.mesh)]


def rank() -> int:
    r = sharding.installed()
    return 0 if r is None else r.mesh.coords[axis_name(r.mesh)]


def divides(width: int) -> bool:
    """Whether the installed tp axis cuts a dim of ``width``
    (``sharding.cuts``: ``sanitize`` leaves it whole otherwise)."""
    return sharding.cuts(width, size())


def sequence_parallel() -> bool:
    """Whether the installed rules lay the sequence axis over tp."""
    r = sharding.installed()
    return size() > 1 and r.resolve(("seq",))[0] == axis_name(r.mesh)


def collective(kind: str, x: torch.Tensor, group, *, dim: int = 0) -> torch.Tensor:
    """The one place the port calls a collective: ``kind`` of ``x`` over
    ``group``, into a new tensor.  ``all_gather`` and ``reduce_scatter``
    concatenate and split along ``dim``."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous() if dim else x.contiguous()
    if kind in ("all_reduce", "all_reduce_max"):
        out = x.clone()
        op = dist.ReduceOp.MAX if kind == "all_reduce_max" else dist.ReduceOp.SUM
        dist.all_reduce(out, op=op, group=group)
        size_ = out
    elif kind == "all_gather":
        out = x.new_empty((x.shape[0] * n,) + x.shape[1:])
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, x, group=group)
        size_ = out
    elif kind == "reduce_scatter":
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim of {x.shape[0]} not divisible by {n}")
        out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
        getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, x, group=group)
        size_ = x
    else:
        raise ValueError(f"unknown collective {kind!r}; known: {', '.join(KINDS)}")
    _count(kind, group, size_.numel() * size_.element_size())
    return out.movedim(0, dim).contiguous() if dim else out


def _count(kind: str, group, b: int) -> None:
    key = f"{kind}@{group_name(group)}"
    counts[kind] += 1
    nbytes[kind] += b
    by_group[key] += 1
    bytes_by_group[key] += b


class _Pinned:
    """Pinned host buffers by (shape, dtype), each back in the pool once
    the message it carried is through: gloo's path for CUDA tensors."""

    def __init__(self):
        self.free: dict = collections.defaultdict(list)
        self.sent: list = []          # (work, the tensor it sends, its pool key or None)

    def take(self, shape, dtype) -> torch.Tensor:
        self.reap(block=False)
        key = (tuple(shape), dtype)
        if self.free[key]:
            return self.free[key].pop()
        return torch.empty(key[0], dtype=dtype, pin_memory=True)

    def reap(self, *, block: bool) -> None:
        keep = []
        for work, buf, key in self.sent:
            if block:
                work.wait()
            elif not work.is_completed():
                keep.append((work, buf, key))
                continue
            if key is not None:
                self.free[key].append(buf)
        self.sent = keep


_pinned = _Pinned()


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a message of ``x`` over ``group`` goes through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def send(x: torch.Tensor, peer: int, group, tag: int) -> None:
    """Post ``x`` to global rank ``peer`` over ``group`` (not waited)."""
    x = x.detach().contiguous()
    key = None
    if _staged(x, group):
        buf = _pinned.take(x.shape, x.dtype)
        buf.copy_(x)
        x, key = buf, (tuple(x.shape), x.dtype)
    _pinned.sent.append((dist.isend(x, peer, group=group, tag=tag), x, key))
    _count("send", group, x.numel() * x.element_size())


def recv(shape, dtype: torch.dtype, device, peer: int, group, tag: int) -> torch.Tensor:
    """The message of ``shape`` and ``dtype`` from global rank ``peer`` over
    ``group``, on ``device``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if _staged(out, group):
        buf = _pinned.take(shape, dtype)
        dist.recv(buf, peer, group=group, tag=tag)
        out.copy_(buf)
        _pinned.free[(tuple(shape), dtype)].append(buf)
    else:
        dist.recv(out, peer, group=group, tag=tag)
    _count("recv", group, out.numel() * out.element_size())
    return out


def wait_sends() -> None:
    """Wait for every posted :func:`send`."""
    _pinned.reap(block=True)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return collective("all_gather", x, group, dim=dim)


def all_reduce(x: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Sum (or ``op="max"``) of ``x`` over the installed tp group; ``x`` as
    it is without one."""
    if size() == 1:
        return x
    return collective("all_reduce_max" if op == "max" else "all_reduce", x, group())


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, one of ``group``'s."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by tp={n}")
    w = x.shape[dim] // n
    return x.narrow(dim, i * w, w).contiguous()


# ---------------------------------------------------------------------------
# the regions
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return collective("all_reduce", dy, ctx.g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return collective("all_reduce", x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, reduce_grad: bool):
        ctx.g, ctx.reduce_grad = g, reduce_grad
        return collective("all_gather", x, g, dim=1)

    @staticmethod
    def backward(ctx, dy):
        if ctx.reduce_grad:
            return collective("reduce_scatter", dy, ctx.g, dim=1), None, None
        return _chunk(dy, 1, ctx.g), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return collective("reduce_scatter", x, g, dim=1)

    @staticmethod
    def backward(ctx, dy):
        return collective("all_gather", dy, ctx.g, dim=1), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim: int):
        ctx.g, ctx.dim = g, dim
        return _chunk(x, dim, g)

    @staticmethod
    def backward(ctx, dy):
        return collective("all_gather", dy, ctx.g, dim=ctx.dim), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, g):
        ctx.dim, ctx.g = dim, g
        return collective("all_gather", x, g, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        return collective("reduce_scatter", dy, ctx.g, dim=ctx.dim), None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return collective("all_reduce", x, g)

    @staticmethod
    def backward(ctx, dy):
        return collective("all_reduce", dy, ctx.g), None


def gather_dim(x: torch.Tensor, dim: int, g) -> torch.Tensor:
    """Every rank's ``x`` of ``g`` concatenated along ``dim``; the backward
    reduce-scatters (each rank's consumer a partial sum of the gradient)."""
    return _GatherDim.apply(x, dim, g)


def sum_over(x: torch.Tensor, g) -> torch.Tensor:
    """Σ of ``x`` over ``g`` where every rank's loss reads the sum: the
    backward sums the cotangents too."""
    return _SumBoth.apply(x, g)


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Enter a column-parallel product from a whole ``x``."""
    return x if size() == 1 else _CopyToTP.apply(x, group())


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum the partial products of a row-parallel product."""
    return x if size() == 1 else _ReduceFromTP.apply(x, group())


def gather_seq(x: torch.Tensor, *, reduce_grad: bool = True) -> torch.Tensor:
    """(B, S/tp, ...) → (B, S, ...).  The backward reduce-scatters (the
    consumer is tp-parallel and each rank's gradient a partial sum) or,
    with ``reduce_grad=False`` (a consumer every rank runs whole), keeps
    this rank's slice."""
    return x if size() == 1 else _GatherSeq.apply(x, group(), reduce_grad)


def reduce_scatter_to_seq(x: torch.Tensor) -> torch.Tensor:
    """Partial sums (B, S, ...) → this rank's slice of their sum (B, S/tp, ...)."""
    return x if size() == 1 else _ReduceScatterSeq.apply(x, group())


def split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of a whole ``x`` along ``dim`` (the backward
    all-gathers)."""
    return x if size() == 1 else _Split.apply(x, group(), dim)


def mine(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's heads of a leaf every tp rank holds whole (a view along
    ``dim``, no collective: the backward fills the other ranks' part with
    zeros, so the leaf's gradient is a partial sum over tp)."""
    n = size()
    if n == 1:
        return x
    w = x.shape[dim] // n
    return x.narrow(dim, rank() * w, w)


def sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over the last dim, whose channels the tp ranks split: a norm's
    statistic over the whole width (summed over tp; the backward sums the
    cotangents, every rank's output reading the sum)."""
    s = torch.sum(x * x, dim=-1, keepdim=True)
    return s if size() == 1 else sum_over(s, group())


def leave_cols(x: torch.Tensor) -> torch.Tensor:
    """This rank's channels (..., d/tp) of a whole (..., d) tensor, placed
    in zeros and summed into the residual stream's layout (the sum of one
    nonzero term per entry, so exact): the row-parallel exit of a block
    whose last product is column-parallel."""
    n = size()
    if n == 1:
        return x
    w, r = x.shape[-1], rank()
    z = x.new_zeros(x.shape[:-1] + (w * (n - 1),))
    return leave(torch.cat([z[..., :r * w], x, z[..., r * w:]], dim=-1))


def enter(x: torch.Tensor) -> torch.Tensor:
    """A tp-parallel block's input: gathered along S under sequence
    parallel, else copied into the region."""
    return gather_seq(x) if sequence_parallel() else copy_to_tp(x)


def leave(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums → the residual stream's layout."""
    return reduce_scatter_to_seq(x) if sequence_parallel() else reduce_from_tp(x)


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------

def vocab_start(rows: int) -> int:
    """The first vocabulary id of this rank's ``rows`` of a sharded table."""
    return rank() * rows


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Look ``ids`` up in this rank's rows of a vocabulary-sharded table:
    an id of another rank's rows gives 0 here, and the all-reduce sums the
    one nonzero row of every id (exactly)."""
    start = vocab_start(table.shape[0])
    local = ids.long() - start
    hit = (local >= 0) & (local < table.shape[0])
    x = table.to(dtype)[torch.where(hit, local, 0)]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=dtype, device=x.device))
    return reduce_from_tp(x)


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, start: int, g):
        m = collective("all_reduce_max", logits.max(dim=-1).values, g)
        e = torch.exp(logits - m[..., None])
        local = labels.long() - start
        hit = torch.arange(logits.shape[-1], device=logits.device) == local[..., None]
        gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
        sums = collective("all_reduce", torch.stack([torch.sum(e, dim=-1), gold]), g)
        ctx.save_for_backward(e, sums[0], local)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, dnll):
        e, s, local = ctx.saved_tensors
        hit = torch.arange(e.shape[-1], device=e.device) == local[..., None]
        grad = (e / s[..., None] - hit.to(e.dtype)) * dnll[..., None]
        return grad, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` of fp32 logits whose
    last axis is this rank's slice of the vocabulary."""
    return _VocabCrossEntropy.apply(logits, labels, vocab_start(logits.shape[-1]), group())


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """(..., V/tp) → (..., V) on every rank, without a gradient: this rank's
    slice placed in zeros, all-reduced (the sum of one nonzero term per
    entry, so exactly the whole logits)."""
    n, i = size(), rank()
    if n == 1:
        return logits
    w = logits.shape[-1]
    out = logits.new_zeros(logits.shape[:-1] + (w * n,))
    out[..., i * w:(i + 1) * w] = logits
    return collective("all_reduce", out, group())
