"""The train and eval steps of StyleSinger (port of
``stylesinger_tpu/training/step.py``).

- the curriculum (``rq_start``, ``forcing``, ``diff_start``) is a
  :class:`Phase` of three flags, taken from the global step;
- the RQ codebooks' EMA statistics are buffers of the model, updated by its
  training pass;
- the optimizer is optax's ``chain(clip_by_global_norm(clip_grad_norm),
  adamw(schedule, b1, b2, eps=1e-8, weight_decay))``, wrapped in
  ``MultiSteps`` when ``accumulate_grad_batches`` > 1, written out to
  optax's definitions (:class:`Optimizer`);
- randomness: one ``torch.Generator`` per JAX stream (``dropout``,
  ``umln``, ``rq``, ``diffusion``), each seeded from (seed, step, stream),
  so a resumed run draws what an unbroken one draws;
- ``compute_dtype`` (``float32`` or ``bfloat16``) is the activation dtype
  of the model's pass (``models/precision.py``); the outputs are cast to
  f32 before the losses, as JAX's ``_f32_tree`` does;
- under a process group (``parallel/mesh.py``) a step is one optimizer
  step on the global batch: the batches are padded to a common bucket, the
  draws, loss denominators, RQ statistics and UMLN batch std are the
  global batch's, and the gradients and losses are summed over the ranks;
- :func:`make_train_scan` runs the steps of a window over a
  device-resident epoch, each a CUDA graph replay on the card
  (``training/graphs.py``), JAX's multi-step dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union,
)

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.models import precision
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training.graphs import GraphedSteps, stack_steps
from stylesinger_torch.training.losses import batch_sums, compute_losses
from stylesinger_torch.training.schedules import make_schedule
from stylesinger_torch.utils import profiling

STREAMS = ("dropout", "umln", "rq", "diffusion")


class Phase(NamedTuple):
    """The curriculum flags of one step."""
    use_rq: bool
    forcing: bool
    use_diff: bool


def phase_for_step(step: int, cfg: Any) -> Phase:
    return Phase(
        use_rq=bool(step > cfg["rq_start"]),
        forcing=bool(step < cfg["forcing"]),
        use_diff=bool(cfg["decoder"] == "diffsinger"
                      and step > cfg["diff_start"]),
    )


def phase_boundaries(cfg: Any) -> tuple:
    """The steps at which :func:`phase_for_step` changes value."""
    return (cfg["forcing"], cfg["rq_start"] + 1, cfg["diff_start"] + 1)


def stream_seed(seed: int, step: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0])


def step_noise(seed: int, step: int,
               device: Union[str, torch.device]) -> Dict[str, Noise]:
    """The noise sources of global step ``step``, one per stream."""
    return {name: Noise(stream_seed(seed, step, i), device)
            for i, name in enumerate(STREAMS)}


def batch_to_device(batch: Dict, device: Union[str, torch.device]
                    ) -> Dict[str, torch.Tensor]:
    """The array fields of a collated batch as tensors on ``device``:
    integers as int64, floats as float32."""
    out = {}
    for k, v in batch.items():
        if k == "nsamples" or not isinstance(v, (np.ndarray, torch.Tensor)):
            continue
        t = torch.as_tensor(v)
        t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device)
    return out


def model_inputs(batch: Dict) -> Dict:
    """A batch as ``StyleSinger.forward(infer=False)`` keywords: the item's
    own mel and f0 are the style reference; the speaker is its id where
    the batch has one (``use_spk_id``), else its d-vector."""
    return dict(
        txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
        spk_embed=batch["spk_id"] if "spk_id" in batch
        else batch["spk_embed"], emo_embed=batch.get("emo_embed"),
        ref_mels=batch["mels"], ref_f0=batch["f0"], f0=batch["f0"],
        uv=batch["uv"], note=batch["notes"], note_dur=batch["note_durs"],
        note_type=batch["note_types"])


def f32_outputs(ret: Dict) -> Dict:
    """bf16 outputs of the model cast to f32 before the losses."""
    return {k: v.float() if isinstance(v, torch.Tensor)
            and v.dtype == torch.bfloat16 else v for k, v in ret.items()}


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of the losses in sorted key order (JAX's tree-leaf order)."""
    return sum(losses[k] for k in sorted(losses))


def adam_moments_(mu: List[torch.Tensor], nu: List[torch.Tensor],
                  grads: List[torch.Tensor], b1: float, b2: float) -> None:
    """optax's moment updates in place: (1 - b) * g + b * m, and the same of
    g^2 (in place, so that a captured step keeps updating the same
    tensors)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))


def bias_corrections(count: int, b1: float, b2: float):
    """1 - b^count for both moments, in f32 as optax takes them."""
    return (float(1 - np.float32(b1) ** np.float32(count)),
            float(1 - np.float32(b2) ** np.float32(count)))


Scalar = Union[float, torch.Tensor]


def adam_direction(mu, nu, c1: Scalar, c2: Scalar, eps: float):
    """optax ``scale_by_adam`` (eps_root 0): mu_hat / (sqrt(nu_hat) + eps),
    with the bias corrections ``c1``, ``c2`` of the count after this
    update (:func:`bias_corrections`; Python floats, or 0-dim device
    tensors holding them)."""
    return torch._foreach_div(
        torch._foreach_div(mu, c1),
        torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)),
                           eps))


def apply_update_(params, upd, lr: Scalar, weight_decay: float = 0.0) -> None:
    """params -= lr * (upd + weight_decay * params), in place (optax
    ``add_decayed_weights`` then ``scale_by_learning_rate``)."""
    if weight_decay:
        upd = torch._foreach_add(upd, torch._foreach_mul(list(params),
                                                         weight_decay))
    torch._foreach_add_(list(params), torch._foreach_mul(upd, -lr))


def write_scalars(buffer: torch.Tensor, values) -> torch.Tensor:
    """Host scalars into a buffer on the device, one fill each (a kernel
    argument, no copy from host memory, so no wait for the device).
    Returns the buffer."""
    for i, v in enumerate(values):
        buffer[i].fill_(v)
    return buffer


class DeviceScalars:
    """An optimizer's host scalars as a tensor on its parameters' device.
    Every update takes them from such a tensor (a 0-dim device tensor in a
    ``_foreach`` op does not round as a Python float does on the card), so
    an eager step and a CUDA graph of it, which reads a buffer written
    before each replay, compute the same."""

    def __init__(self, n: int):
        self.n = n
        self._buf: Optional[torch.Tensor] = None

    def write(self, values, device: torch.device) -> torch.Tensor:
        """A buffer of its own holding ``values`` (for an eager step)."""
        if self._buf is None or self._buf.device != device:
            self._buf = torch.empty(self.n, device=device)
        return write_scalars(self._buf, values)


class Optimizer:
    """optax ``chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps=1e-8, eps_root=0, weight_decay))``, in ``MultiSteps(k)`` when
    ``accumulate_grad_batches`` k > 1:

    - clipping scales by ``clip / g_norm`` only when ``g_norm >= clip``;
    - the learning rate is the schedule at the count before the update;
    - with k > 1 the gradients are averaged over k calls and the inner
      update is applied at every k-th call.

    A parameter without a gradient counts as a zero gradient.  The moments
    and the accumulated gradients are updated in place.  The host scalars
    of an update (:meth:`scalars`) reach the device as a tensor
    (:class:`DeviceScalars`), or in a buffer the caller writes, which a
    CUDA graph of the step reads (``training/graphs.py``); the branch on
    the accumulation micro-step stays on the host (:meth:`graph_key`)."""

    def __init__(self, named_params: Dict[str, nn.Parameter], cfg: Any):
        self.names = list(named_params)
        self.schedule = make_schedule(cfg)
        self.clip = float(cfg["clip_grad_norm"])
        self.b1 = float(cfg["optimizer_adam_beta1"])
        self.b2 = float(cfg["optimizer_adam_beta2"])
        self.eps = 1e-8
        self.weight_decay = float(cfg["weight_decay"])
        self.k = int(cfg.get("accumulate_grad_batches", 1))
        params = list(named_params.values())
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params] if self.k > 1 \
            else None
        self._scalars = DeviceScalars(3)

    def scalars(self) -> tuple:
        """(learning rate, c1, c2) of the update that takes the count to
        count + 1, as Python floats."""
        return (self.schedule(self.count),) + bias_corrections(
            self.count + 1, self.b1, self.b2)

    def graph_key(self) -> tuple:
        """What the next call branches on on the host."""
        return (self.mini_step,)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor],
             grads: List[Optional[torch.Tensor]],
             scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Updates ``params`` in place; returns the gradients' global norm
        (before clipping).  ``scalars``: a [3] device buffer holding
        :meth:`scalars`, written by the caller (a captured step); None:
        written here."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        g_norm = mesh.global_norm(params, grads)
        if self.k > 1:
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % self.k
            if self.mini_step != 0:
                return g_norm
            norm = mesh.global_norm(params, self.acc)
            self._adamw(params, self.acc, norm, scalars)
            torch._foreach_zero_(self.acc)
        else:
            self._adamw(params, grads, g_norm, scalars)
        return g_norm

    def _adamw(self, params, grads, norm, scalars):
        keep = norm < self.clip
        one = torch.ones_like(norm)
        grads = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, self.clip)))
        if scalars is None:
            scalars = self._scalars.write(self.scalars(), norm.device)
        lr, c1, c2 = scalars.unbind()
        self.count += 1
        adam_moments_(self.mu, self.nu, grads, self.b1, self.b2)
        upd = adam_direction(self.mu, self.nu, c1, c2, self.eps)
        apply_update_(params, upd, lr, self.weight_decay)

    def state_dict(self) -> Dict[str, Any]:
        out = {"count": self.count, "mini_step": self.mini_step,
               "mu": dict(zip(self.names, self.mu)),
               "nu": dict(zip(self.names, self.nu))}
        if self.acc is not None:
            out["acc"] = dict(zip(self.names, self.acc))
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        for key in ("mu", "nu", "acc"):
            if getattr(self, key) is None:
                continue
            setattr(self, key, [sd[key][n].to(t.device, t.dtype).clone()
                                for n, t in zip(self.names,
                                                getattr(self, key))])


@dataclass
class TrainState:
    """The model (parameters and RQ buffers), its optimizer and the number
    of steps taken."""
    model: nn.Module
    opt: Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def init_state(model: nn.Module, cfg: Any,
               seed: Optional[int] = None) -> TrainState:
    """Seeded random weights for ``model`` (on its device), the EMA copy of
    each codebook equal to the codebook and zero cluster sizes, and a fresh
    optimizer."""
    from stylesinger_torch.inference import init_random_

    g = torch.Generator().manual_seed(int(cfg["seed"] if seed is None
                                          else seed))
    device = next(model.parameters()).device
    init_random_(model.cpu(), g)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "embed_ema"):
                m.embed_ema.copy_(m.embedding)
                m.cluster_size_ema.zero_()
    model.to(device)
    return TrainState(model, Optimizer(dict(model.named_parameters()), cfg))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               phase: Phase, cfg: Any,
               noise: Optional[Dict[str, Any]] = None,
               scalars: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch of tensors on the model's device
    (:func:`batch_to_device`); under a process group, on the global batch
    of which ``batch`` is this rank's part.  ``noise`` replaces the step's
    own sources (:func:`step_noise`; the global batch's draws); a
    ``dropout`` entry of None turns dropout off.  ``scalars``: the
    optimizer's host scalars in a device buffer (``Optimizer.step``).
    Returns the losses, ``total_loss`` and ``grad_norm`` (detached;
    global)."""
    model = state.model
    if noise is None:
        noise = step_noise(cfg["seed"], state.step, state.device)
    shard = None
    if mesh.distributed():
        batch, shard = mesh.shard_batch(batch, batch_sums(batch))
        noise = shard.noise(noise)
    params = list(model.parameters())
    for p in params:
        p.grad = None
    with mesh.sharded(shard):
        with profiling.span("train.forward", n=1):
            with precision.activation_dtype(cfg.get("compute_dtype",
                                                    "float32")):
                ret = model(**model_inputs(batch), noise=noise, infer=False,
                            use_rq=phase.use_rq, forcing=phase.forcing,
                            use_diff=phase.use_diff)
            losses = compute_losses(f32_outputs(ret), batch, cfg,
                                    use_rq=phase.use_rq,
                                    forcing=phase.forcing,
                                    use_diff=phase.use_diff)
            total = total_loss(losses)
        with profiling.span("train.backward", n=1):
            total.backward()
    if shard is not None:
        mesh.all_reduce_grads(params)
    with profiling.span("train.optimizer", n=1):
        grad_norm = state.opt.step(params, [p.grad for p in params],
                                   scalars)
    state.step += 1
    keys = sorted(losses)
    values = torch.stack([losses[k].detach() for k in keys])
    if shard is not None:
        values = mesh.all_reduce_sum(values)
    metrics = dict(zip(keys, values.unbind()))
    metrics["total_loss"] = total_loss(metrics)
    metrics["grad_norm"] = grad_norm
    return metrics


def make_train_scan(cfg: Any,
                    noise_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
                    log: Callable[[str], None] = print) -> "TrainScan":
    """Multi-step dispatch (JAX's ``make_train_scan``): returns a
    :class:`TrainScan`, ``scan(state, stacked, order, phase) -> metrics``,
    each a [W] vector on the device, for the W steps of a window.

    ``stacked`` is the device-resident epoch (``Trainer._stack_batches``:
    each field with a leading batch-index axis, every batch padded to one
    shape); step ``j`` of the window trains on batch ``order[j]``, gathered
    by ``index_select`` inside the step, with the draws of its global step
    (``step_noise``, or ``noise_fn(step)``), so the stream continues across
    windows and resumes.  Every step of a window runs under ``phase``.

    On the card each step is a replay of a CUDA graph of
    :func:`train_step` at the epoch's one shape, one graph per (phase,
    accumulation micro-step); the first step of each is a real eager step,
    which the capture follows (``training/graphs.py``; ``scan.graphs``).
    On the CPU each step runs eagerly through the same code.  Refuses a process group: the
    batch index and the epoch are this process's own."""
    return TrainScan(cfg, noise_fn, log)


class TrainScan:
    """:func:`make_train_scan`'s windows; ``graphs`` holds the graphs of
    the last (state, epoch) it ran on."""

    def __init__(self, cfg: Any,
                 noise_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
                 log: Callable[[str], None] = print):
        self.cfg, self.noise_fn = cfg, noise_fn
        self.graphs = GraphedSteps(
            lambda st: ((st, "step"), (st.opt, "count"),
                        (st.opt, "mini_step")), log)

    def __call__(self, state: TrainState, stacked: Dict[str, torch.Tensor],
                 order: Sequence[int], phase: Phase
                 ) -> Dict[str, torch.Tensor]:
        if mesh.distributed():
            raise ValueError("steps_per_dispatch > 1 under a process group")
        cfg, graphs = self.cfg, self.graphs
        graphs.bind(state, stacked)
        idx = graphs.buffer("index", (1,), torch.long)
        scalars = graphs.buffer("scalars", (3,))

        def body(noise):
            batch = {k: v.index_select(0, idx)[0] for k, v in stacked.items()}
            return train_step(state, batch, phase, cfg, noise=noise,
                              scalars=scalars)

        def steps():
            for j in order:
                idx.fill_(int(j))
                write_scalars(scalars, state.opt.scalars())
                sources = self.noise_fn(state.step) if self.noise_fn \
                    is not None else step_noise(cfg["seed"], state.step,
                                                state.device)
                yield graphs.run((phase, state.opt.graph_key()), body,
                                 sources)

        return stack_steps(steps())


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              phase: Phase, cfg: Any,
              noise: Optional[Dict[str, Any]] = None
              ) -> Dict[str, torch.Tensor]:
    """Validation losses: deterministic (no dropout, UMLN or codebook
    update), with the step's diffusion draws."""
    if noise is None:
        noise = step_noise(cfg["seed"], state.step, state.device)
    with precision.activation_dtype(cfg.get("compute_dtype", "float32")):
        ret = state.model(**model_inputs(batch), noise=noise, infer=False,
                          use_rq=phase.use_rq, forcing=phase.forcing,
                          use_diff=phase.use_diff, deterministic=True)
    losses = compute_losses(f32_outputs(ret), batch, cfg,
                            use_rq=phase.use_rq, forcing=phase.forcing,
                            use_diff=phase.use_diff)
    losses["total_loss"] = total_loss(losses)
    return losses
