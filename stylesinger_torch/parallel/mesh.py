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
variables (NCCL on CUDA, gloo on the CPU).  The JAX package's ``model``
axis (``param_shardings``, the Megatron FFN split) is not ported:
:func:`check_mesh_shape` refuses a ``model`` axis larger than 1.
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
    """The port has the ``data`` axis only: a ``model`` axis larger than 1
    (the JAX package's tensor-parallel FFN split) raises, as does a
    ``data`` size other than -1 or the number of processes."""
    shape = dict(mesh_shape or {})
    if int(shape.get("model", 1)) != 1:
        raise NotImplementedError(
            "mesh_shape model > 1 (the Megatron FFN split over the model "
            "axis) is not ported; the port trains data parallel only")
    n = int(shape.get("data", -1))
    if n not in (-1, world_size()):
        raise ValueError(f"mesh_shape data={n}, but {world_size()} "
                         "process(es) run")


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
    r, w = rank(), world_size()
    keys = sorted(sums)
    shapes = torch.zeros(w, 3, dtype=torch.float64)
    shapes[r] = torch.tensor([batch["mels"].shape[0], batch["mels"].shape[1],
                              batch["txt_tokens"].shape[1]],
                             dtype=torch.float64)
    buf = torch.cat([shapes.reshape(-1).to(dev)] +
                    [sums[k].reshape(1).to(torch.float64) for k in keys])
    dist.all_reduce(buf)
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
    r = rank()
    offset = sum(counts[:r])
    out = x.new_zeros((sum(counts),) + tuple(x.shape[1:]))
    out[offset:offset + x.shape[0]] = x
    dist.all_reduce(out)
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
        dist.all_reduce(g)
        return g[ctx.offset:ctx.offset + ctx.rows], None, None


def gather_rows_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows` with a gradient: the backward sums the ranks'
    gradients of the gathered tensor and keeps this rank's rows."""
    if _SHARD is None:
        return x
    return _GatherGrad.apply(x, _SHARD.offset, _SHARD.counts)


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks (a missing gradient
    counts as zero), in one flat buffer."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    i = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[i:i + n].view_as(g)
        i += n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over the ranks."""
    t = t.detach().clone()
    dist.all_reduce(t)
    return t
