"""Data parallel training across processes (port of
``stylesinger_tpu/parallel/mesh.py``).

One process per device, each with its own local batch (``EpochBatches``'
``rank`` / ``world_size`` split).  A train step is ONE optimizer step on
the global batch, the concatenation of the ranks' local batches in rank
order, as the JAX package's step on a ``data``-sharded global array is.
Wrapping the model in DDP and averaging the gradients would be another
step, so the pieces are explicit:

- :func:`shard_batch` pads every rank's batch to the largest frame and
  token bucket among the ranks and makes its :class:`Shard`, this rank's
  rows of the global batch, with the global sums of the masks the losses
  divide by: one ``all_reduce`` and one read on the host a step;
- while a step runs under :func:`sharded`, the losses divide by those
  global counts (:func:`global_sum`) and by global element counts, which
  the shard knows on the host (:func:`global_mean`, :func:`global_numel`);
  the RQ codebooks take their EMA step and restarts on the gathered global
  batch (:func:`gather_rows`, one ``all_reduce`` a codebook), and UMLN
  takes its batch std over the global batch (:func:`gather_rows_grad`);
- :meth:`Shard.noise` makes every draw at the global batch's shape from the
  same seeded stream on every rank, each rank keeping its own rows;
- :func:`all_reduce_grads` sums the ranks' gradients: each rank's loss is
  its share of the global loss, so the sum is the global gradient.

:func:`init_distributed` starts ``torch.distributed`` from torchrun's
variables (NCCL on CUDA, gloo on the CPU).

The JAX package's 2-D ``('data', 'model')`` mesh is :func:`make_mesh`: the
processes as an ``n_data x n_model`` grid, rank r at data index
``r // n_model`` and model index ``r % n_model`` (JAX's reshape of its
devices in order).  The ranks of one model group (one data index) hold the
same rows of the batch; every collective of the data-parallel step above
runs over the data group (one model index), so those rows count once.
:func:`param_shardings` / :func:`shard_params` split every
``TransformerFFN`` Megatron-style over the model group (JAX's path rule:
the conv's kernel on its 4h output channels, the dense kernel on its 4h
input features), and :class:`ShardedFFN` then runs each FFN's chunk and
sums its partial outputs over the group.  Without a mesh the process group is one ``data``
axis, as before.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the batch fields whose axis 1 is frames, and those whose axis 1 is phones
FRAME_FIELDS = ("mels", "mel2ph", "f0", "uv", "energy")
TOKEN_FIELDS = ("txt_tokens", "notes", "note_durs", "note_types", "is_sil")


def init_distributed(device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Start the process group from torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    ``cuda:LOCAL_RANK``): NCCL for a CUDA ``device``, gloo for the CPU, or
    ``backend`` (gloo also runs ranks that share one card, which NCCL
    refuses).  Returns True when a group is running (also when it already
    was), False when the variables are not set (one process)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world)
    return True


def distributed() -> bool:
    """Whether a process group runs (at any world size)."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device: Union[str, torch.device]) -> torch.device:
    """``cuda:LOCAL_RANK`` for a CUDA ``device`` under a process group,
    else ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def check_mesh_shape(mesh_shape: Optional[Dict[str, int]]) -> None:
    """The config key ``mesh_shape`` sets no layout (the JAX package's
    trainer never reads it either): a ``model`` size larger than 1 raises,
    naming the calls that build the grid, and so does a ``data`` size
    other than -1 or the processes of the data axis."""
    shape = dict(mesh_shape or {})
    if int(shape.get("model", 1)) != 1:
        raise NotImplementedError(
            "mesh_shape model > 1: the config key does not split the model "
            "(the JAX package's trainer ignores it); build the grid with "
            "parallel.mesh.make_mesh(n_data, n_model), split the FFNs with "
            "shard_params(model, mesh) and step with train_step, or pass "
            "Trainer(mesh=make_mesh(...)) for the data axis")
    n = int(shape.get("data", -1))
    if n not in (-1, data_size()):
        raise ValueError(f"mesh_shape data={n}, but the data axis has "
                         f"{data_size()} process(es)")


# ---------------------------------------------------------------------------
# The 2-D grid: data x model
# ---------------------------------------------------------------------------

@dataclass
class Mesh:
    """The processes as an ``n_data x n_model`` grid.  ``data_group``: the
    ranks of this rank's model index (its column: the batch splits over
    them); ``model_group``: the ranks of its data index (its row: the FFNs
    split over them, and they hold the same rows)."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any


_MESH: Optional[Mesh] = None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The grid over the running process group (every rank calls it, in the
    same order as its other collectives), ``n_data`` defaulting to the
    processes over ``n_model``; it becomes the process's mesh
    (:func:`use_mesh`).  One process group per row and per column."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group runs "
                           "(init_distributed first)")
    world = world_size()
    if n_data is None or n_data < 0:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: {n_data} x {n_model} != the "
                         f"{world} processes")
    r = rank()
    rows = [dist.new_group([d * n_model + m for m in range(n_model)])
            for d in range(n_data)]
    cols = [dist.new_group([d * n_model + m for d in range(n_data)])
            for m in range(n_model)]
    return use_mesh(Mesh(n_data, n_model, r // n_model, r % n_model,
                         cols[r % n_model], rows[r // n_model]))


def use_mesh(m: Optional[Mesh]) -> Optional[Mesh]:
    """Makes ``m`` the process's mesh (None: the process group is one data
    axis); returns it."""
    global _MESH
    _MESH = m
    return m


def data_group():
    """The process group of the data axis (None: the whole group)."""
    return None if _MESH is None else _MESH.data_group


def data_rank() -> int:
    return rank() if _MESH is None else _MESH.data_index


def data_size() -> int:
    return world_size() if _MESH is None else _MESH.n_data


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the grid: split along ``dim`` over the mesh
    axis ``axis`` ("data" or "model"), or replicated (``axis`` None)."""
    axis: Optional[str] = None
    dim: int = 0

    def local(self, x: torch.Tensor, m: Mesh) -> torch.Tensor:
        """This rank's part of the global tensor ``x``."""
        if self.axis is None:
            return x
        n, i = (m.n_data, m.data_index) if self.axis == "data" else \
            (m.n_model, m.model_index)
        return x.chunk(n, dim=self.dim)[i].contiguous()


def batch_sharding(m: Mesh) -> Sharding:
    """A batch's leading axis split over ``data`` (the ranks of a model
    group hold the same rows)."""
    return Sharding("data", 0)


def replicate_sharding(m: Mesh) -> Sharding:
    return Sharding()


def _ffn_split_dim(name: str, ndim: int) -> Optional[int]:
    """JAX's ``param_shardings`` path rule on the port's names and layouts:
    ``...TransformerFFN_0.Conv_0.weight`` [4h, h, k] on its output channels,
    ``...TransformerFFN_0.LambdaDense_0.Dense_0.weight`` [h, 4h] on its input
    features; None for every other leaf."""
    if "TransformerFFN" in name and name.endswith("weight"):
        if ".Conv_0." in name and ndim == 3:
            return 0
        if ".LambdaDense_0." in name and ndim == 2:
            return 1
    return None


def param_shardings(m: Mesh, state_dict: Dict[str, torch.Tensor]
                    ) -> Dict[str, Sharding]:
    """The tensor-parallel layout of a model's ``state_dict`` on the
    ``model`` axis: the two FFN kernels of every ``TransformerFFN`` split
    (:func:`_ffn_split_dim`), everything else replicated."""
    out = {}
    for name, x in state_dict.items():
        dim = _ffn_split_dim(name, x.ndim)
        out[name] = replicate_sharding(m) if dim is None else \
            Sharding("model", dim)
    return out


def shard_params(model: torch.nn.Module, m: Mesh) -> torch.nn.Module:
    """Splits ``model``'s FFN kernels over ``m``'s model group in place
    (each rank keeps its chunk, as a new parameter marked with its split
    ``model_dim``) and puts a :class:`ShardedFFN` in place of every
    ``TransformerFFN`` that holds them.  Build the optimizer after this
    call."""
    specs = param_shardings(m, dict(model.named_parameters()))
    if m.n_model == 1 or not any(s.axis for s in specs.values()):
        return model
    ffns = set()
    for name, spec in specs.items():
        if spec.axis is None:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = torch.nn.Parameter(spec.local(mod._parameters[leaf].detach(), m))
        p.model_dim = spec.dim
        mod._parameters[leaf] = p
        # the TransformerFFN that owns this Conv_0 / LambdaDense_0
        ffns.add(owner.rsplit(".Conv_0", 1)[0].rsplit(".LambdaDense_0", 1)[0])
    for name in sorted(ffns):
        parent, _, leaf = name.rpartition(".")
        owner = model.get_submodule(parent)
        setattr(owner, leaf, ShardedFFN(getattr(owner, leaf), m))
    return model


class ShardedFFN(torch.nn.Module):
    """A ``TransformerFFN`` (``models/common.py``) on this rank's chunk of
    the 4h channels: the conv's output channels and the dense's input
    features (:func:`shard_params`).  It runs its chunk (the conv's bias
    sliced to it, its columns of the global dropout mask) and sums the
    partial dense outputs over the model group before the dense's bias:
    Megatron's column- then row-parallel pair, whose backward sums the
    input's gradient and the conv bias's over the group.  It takes over
    the FFN's submodules, so the state dict's names stay."""

    def __init__(self, ffn: torch.nn.Module, m: Mesh):
        super().__init__()
        # imported here: the model modules import this one
        from stylesinger_torch.models.common import dropout
        from stylesinger_torch.models.precision import const
        self._dropout, self._const = dropout, const
        self.kernel_size, self.act = ffn.kernel_size, ffn.act
        self.dropout = ffn.dropout
        self.Conv_0, self.LambdaDense_0 = ffn.Conv_0, ffn.LambdaDense_0
        self.mesh = m

    def forward(self, x, drop=None):
        m, conv = self.mesh, self.Conv_0
        dense = self.LambdaDense_0.Dense_0
        n = conv.weight.shape[0]
        lo = m.model_index * n
        no_bias = {"bias": None}   # each layer's own dtype rule, no bias
        y = torch.func.functional_call(conv, no_bias, (copy_to_model(x, m),))
        y = y + copy_to_model(conv.bias, m)[lo:lo + n].to(y.dtype)
        y = self.act(y * self._const(self.kernel_size ** -0.5, y.dtype))
        if drop is not None:
            drop = ColumnNoise(drop, lo, n * m.n_model)
        y = self._dropout(y, self.dropout, drop)
        out = reduce_from_model(
            torch.func.functional_call(dense, no_bias, (y,)), m)
        return out + dense.bias.to(out.dtype)


def split_dims(model: torch.nn.Module) -> Dict[str, int]:
    """The names of ``model``'s split parameters and their split dims."""
    return {name: p.model_dim for name, p in model.named_parameters()
            if getattr(p, "model_dim", None) is not None}


def full_tensors(model: torch.nn.Module, named: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``named`` (a state dict, or optimizer moments by parameter name) with
    each split leaf gathered to its full layout over the model group (a
    collective: every rank of the group calls it)."""
    dims = split_dims(model)
    if not dims:
        return dict(named)
    out = dict(named)
    for name, dim in dims.items():
        if name not in named:
            continue
        x = named[name]
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * _MESH.n_model
        full = x.new_zeros(shape)
        full.narrow(dim, _MESH.model_index * n, n).copy_(x)
        dist.all_reduce(full, group=_MESH.model_group)
        out[name] = full
    return out


def local_tensors(model: torch.nn.Module, named: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`full_tensors`: this rank's chunk of each split
    leaf of full-layout tensors."""
    dims = split_dims(model)
    return {k: Sharding("model", dims[k]).local(v, _MESH) if k in dims
            else v for k, v in named.items()}


def global_norm(params: Sequence[torch.Tensor],
                tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm of ``tensors`` (one per parameter of ``params``): a
    split parameter's squares are summed over the model group, so every
    rank of the group gets the same value."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    split = [getattr(p, "model_dim", None) is not None for p in params]
    if not any(split):
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(split, device=norms.device)
    sq = norms.square()
    part = torch.where(mask, sq, torch.zeros_like(sq)).sum()
    dist.all_reduce(part, group=_MESH.model_group)
    return torch.sqrt(torch.where(mask, torch.zeros_like(sq), sq).sum()
                      + part)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The forward sums over the model group; identity backward (g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, m: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, m.model_group)


def reduce_from_model(x: torch.Tensor, m: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, m.model_group)


class ColumnNoise:
    """A noise source whose Bernoulli draws of shape (..., n) are columns
    [lo, lo + n) of the draw (..., full) of ``inner``: a model shard's
    slice of the global dropout mask."""

    def __init__(self, inner, lo: int, full: int):
        self.inner, self.lo, self.full = inner, lo, full

    def bernoulli(self, p, shape=()):
        shape = tuple(shape)
        mask = self.inner.bernoulli(p, shape[:-1] + (self.full,))
        return mask[..., self.lo:self.lo + shape[-1]]


# ---------------------------------------------------------------------------
# The global batch
# ---------------------------------------------------------------------------

def shard_batch(batch: Dict[str, torch.Tensor],
                sums: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], "Shard"]:
    """This rank's ``batch`` with every frame field padded with zeros to
    the longest frame axis among the ranks and every phone field to the
    longest phone axis (two ranks' batches may sit in different buckets),
    and its :class:`Shard`.  ``sums`` are this rank's sums of the masks
    the losses divide by (scalars that padding leaves alone); the shard
    holds their sums over the ranks.  One ``all_reduce`` (f64: the rows and
    lengths of every rank, then the sums) and one read on the host."""
    dev = batch["mels"].device
    r, w = data_rank(), data_size()
    keys = sorted(sums)
    shapes = torch.zeros(w, 3, dtype=torch.float64)
    shapes[r] = torch.tensor([batch["mels"].shape[0], batch["mels"].shape[1],
                              batch["txt_tokens"].shape[1]],
                             dtype=torch.float64)
    buf = torch.cat([shapes.reshape(-1).to(dev)] +
                    [sums[k].reshape(1).to(torch.float64) for k in keys])
    dist.all_reduce(buf, group=data_group())
    shapes = [[int(v) for v in row] for row in
              buf[:3 * w].reshape(w, 3).tolist()]
    counts = [row[0] for row in shapes]
    t_mel = max(row[1] for row in shapes)
    t_txt = max(row[2] for row in shapes)
    out = {}
    for k, v in batch.items():
        length = t_mel if k in FRAME_FIELDS else \
            t_txt if k in TOKEN_FIELDS else None
        if length is not None and v.shape[1] < length:
            pad = [0, 0] * (v.ndim - 2) + [0, length - v.shape[1]]
            v = F.pad(v, pad)
        out[k] = v
    shard = Shard(sum(counts[:r]), counts[r], sum(counts), counts,
                  dict(zip(keys, buf[3 * w:].float().unbind())))
    return out, shard


class _RowNoise:
    """A noise source whose draws of shape (rows, ...) are the global draw
    (total, ...) of ``inner`` cut to rows [offset, offset + rows); scalar
    draws pass through."""

    def __init__(self, inner, shard: "Shard"):
        self.inner = inner
        self.shard = shard

    def _rows(self, fn, shape, *args):
        shape = tuple(shape)
        if not shape:
            return fn(shape, *args)
        s = self.shard
        if shape[0] != s.rows:
            raise ValueError(f"draw {shape} does not lead with this rank's "
                             f"{s.rows} rows")
        full = fn((s.total,) + shape[1:], *args)
        return full[s.offset:s.offset + s.rows]

    def normal(self, shape):
        return self._rows(self.inner.normal, shape)

    def uniform(self, shape):
        return self._rows(self.inner.uniform, shape)

    def randint(self, shape, low, high):
        return self._rows(lambda sh: self.inner.randint(sh, low, high), shape)

    def bernoulli(self, p, shape=()):
        return self._rows(lambda sh: self.inner.bernoulli(p, sh), shape)


@dataclass
class Shard:
    """This rank's rows [offset, offset + rows) of a global batch of
    ``total`` rows; ``counts`` are every rank's rows in rank order, and
    ``sums`` the global batch's mask sums (:func:`shard_batch`), each a
    scalar on the device."""
    offset: int
    rows: int
    total: int
    counts: List[int]
    sums: Dict[str, torch.Tensor]

    def noise(self, sources: Dict[str, Any],
              streams: Sequence[str] = ("dropout", "umln", "diffusion")
              ) -> Dict[str, Any]:
        """The step's sources with ``streams`` cut to this rank's rows (a
        None source, dropout off, stays None).  The RQ stream draws on the
        gathered global batch and is left whole."""
        return {k: _RowNoise(v, self) if v is not None and k in streams
                else v for k, v in sources.items()}


_SHARD: Optional[Shard] = None


def current() -> Optional[Shard]:
    """The shard of the step being run, or None (one process, or outside
    a data-parallel step)."""
    return _SHARD


@contextlib.contextmanager
def sharded(shard: Optional[Shard]):
    global _SHARD
    old = _SHARD
    _SHARD = shard
    try:
        yield
    finally:
        _SHARD = old


def global_sum(x: torch.Tensor, key: str) -> torch.Tensor:
    """A loss's denominator: ``x``, this rank's sum of the mask ``key``
    (``training/losses.py::batch_sums``), or, in a data-parallel step, the
    global batch's, which :func:`shard_batch` summed over the ranks."""
    if _SHARD is None:
        return x
    return _SHARD.sums[key]


def global_numel(x: torch.Tensor) -> float:
    """The number of elements of ``x`` [rows, ...] over the global batch:
    ``x.numel()`` outside a shard, else what the ranks' rows hold."""
    if _SHARD is None:
        return float(x.numel())
    if x.shape[0] != _SHARD.rows:
        raise ValueError(f"{tuple(x.shape)} does not lead with this rank's "
                         f"{_SHARD.rows} rows")
    return float(x.numel() // _SHARD.rows * _SHARD.total)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch: this rank's sum over the number
    of elements on all ranks (each rank's share of the global mean)."""
    if _SHARD is None:
        return x.mean()
    return x.sum() / global_numel(x)


def _gather(x: torch.Tensor, counts: List[int]) -> torch.Tensor:
    """The ranks' ``x`` concatenated along axis 0 in rank order (ranks may
    hold different numbers of rows).  Each rank writes its rows into zeros
    at its offset and the ranks sum: only ``all_reduce``, which gloo also
    runs on CUDA tensors (its ``all_gather`` takes CPU tensors only)."""
    offset = sum(counts[:data_rank()])
    out = x.new_zeros((sum(counts),) + tuple(x.shape[1:]))
    out[offset:offset + x.shape[0]] = x
    dist.all_reduce(out, group=data_group())
    return out


def gather_rows(xs: Sequence[torch.Tensor], rows_per_item: int = 1
                ) -> List[torch.Tensor]:
    """Each of ``xs`` (each [rows * rows_per_item, ...]) of every rank,
    concatenated in rank order (no gradient); ``xs`` as they are outside a
    shard.  One ``all_reduce`` for all of them, as columns of their common
    floating type (integers such as codebook indices stay exact below
    2 ** 24)."""
    xs = list(xs)
    if _SHARD is None:
        return xs
    dt = torch.float32
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    n = xs[0].shape[0]
    cols = [x.detach().reshape(n, -1).to(dt) for x in xs]
    g = _gather(torch.cat(cols, dim=1),
                [c * rows_per_item for c in _SHARD.counts])
    out, i = [], 0
    for x, c in zip(xs, cols):
        out.append(g[:, i:i + c.shape[1]].reshape(
            (g.shape[0],) + tuple(x.shape[1:])).to(x.dtype))
        i += c.shape[1]
    return out


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, counts):
        ctx.offset, ctx.rows = offset, x.shape[0]
        return _gather(x, counts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=data_group())
        return g[ctx.offset:ctx.offset + ctx.rows], None, None


def gather_rows_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows` with a gradient: the backward sums the ranks'
    gradients of the gathered tensor and keeps this rank's rows."""
    if _SHARD is None:
        return x
    return _GatherGrad.apply(x, _SHARD.offset, _SHARD.counts)


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks of the data axis (a
    missing gradient counts as zero), in one flat buffer.  On a mesh with
    a model axis, the replicated parameters' gradients are then taken from
    the model group's first rank: the ranks of a group compute them from
    the same values, but the card's backward kernels may sum in another
    order on each (atomics), and replicated weights must stay equal."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=data_group())
    i = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[i:i + n].view_as(g)
        i += n
    if _MESH is None or _MESH.n_model == 1:
        return
    rep = [p for p in params if getattr(p, "model_dim", None) is None]
    flat = torch.cat([p.grad.reshape(-1) for p in rep])
    if _MESH.model_index:
        flat.zero_()
    dist.all_reduce(flat, group=_MESH.model_group)  # first rank's, exactly
    i = 0
    for p in rep:
        n = p.grad.numel()
        p.grad = flat[i:i + n].view_as(p.grad)
        i += n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over the ranks of the data axis."""
    t = t.detach().clone()
    dist.all_reduce(t, group=data_group())
    return t
