"""The port's acoustic training step, frozen on the plain modules: the
curriculum phase, the seeded initial weights, the epoch's batches padded
to one shape and the batch schedule, the training pass and its losses,
and optax's ``chain(clip_by_global_norm, adamw)`` written out plainly
(``training/step.py``, ``training/trainer.py``, ``inference.py``'s
``init_random_``).  One process, f32, no graphs, no dispatch windows."""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from .batching import BucketBatcher
from .dataset import StyleSingerDataset
from .losses import compute_losses
from .schedules import make_schedule


class Phase(NamedTuple):
    use_rq: bool
    forcing: bool
    use_diff: bool


def phase_for_step(step: int, cfg: Any) -> Phase:
    return Phase(use_rq=bool(step > cfg["rq_start"]),
                 forcing=bool(step < cfg["forcing"]),
                 use_diff=bool(cfg["decoder"] == "diffsinger"
                               and step > cfg["diff_start"]))


def init_weights(model: nn.Module, seed: int) -> None:
    """The port's seeded initial weights (``init_state``): on the host,
    from ``torch.Generator().manual_seed(seed)`` in parameter order,
    matrices N(0, 1/fan_in), biases 0, norm scales 1, codebooks N(0, 1);
    each codebook's EMA copy equal to it and its cluster sizes 0."""
    g = torch.Generator().manual_seed(int(seed))
    device = next(model.parameters()).device
    model.cpu()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g)
                        * p[0].numel() ** -0.5)
            elif name.endswith("bias") or "bias_" in name:
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in model.named_buffers():
            if ".codebook_" in name and name.endswith(".embedding"):
                b.copy_(torch.randn(b.shape, generator=g))
        for m in model.modules():
            if hasattr(m, "embed_ema"):
                m.embed_ema.copy_(m.embedding)
                m.cluster_size_ema.zero_()
    model.to(device)


def epoch_batches(cfg: Any, items: List[Dict]) -> List[Dict]:
    """The first epoch's batches of the port's bucket batcher."""
    ds = StyleSingerDataset(cfg, "train", items)
    return list(BucketBatcher(ds, cfg).batches(0))


def stack_epoch(batches: List[Dict], device) -> Dict[str, torch.Tensor]:
    """Every batch zero-padded to the epoch's largest size in each
    dimension and stacked (integers int64, floats f32)."""
    keys = sorted(set.intersection(*(set(b) for b in batches)))
    keys = [k for k in keys if isinstance(batches[0][k], np.ndarray)
            and k != "nsamples"]
    out = {}
    for k in keys:
        arrs = [np.asarray(b[k]) for b in batches]
        shape = [max(s) for s in zip(*(a.shape for a in arrs))]
        stacked = np.stack([np.pad(a, [(0, t - s) for s, t in
                                       zip(a.shape, shape)]) for a in arrs])
        t = torch.as_tensor(stacked)
        out[k] = (t.float() if t.is_floating_point() else t.long()).to(
            device)
    return out


def batch_index(t: int, n_b: int, seed: int) -> int:
    """The batch of global step ``t``: epoch ``t // n_b`` visits the
    batches in the order of ``default_rng(seed + epoch).permutation``."""
    return int(np.random.default_rng(seed + t // n_b).permutation(n_b)
               [t % n_b])


def model_inputs(batch: Dict) -> Dict:
    return dict(
        txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
        spk_embed=batch["spk_embed"], emo_embed=batch.get("emo_embed"),
        ref_mels=batch["mels"], ref_f0=batch["f0"], f0=batch["f0"],
        uv=batch["uv"], note=batch["notes"], note_dur=batch["note_durs"],
        note_type=batch["note_types"])


class AdamW:
    """clip_by_global_norm(clip) then adamw(schedule, b1, b2, eps=1e-8,
    weight_decay): the learning rate at the count before the update, the
    bias corrections of the count after it, in f32."""

    def __init__(self, params: List[nn.Parameter], cfg: Any):
        self.params = params
        self.schedule = make_schedule(cfg)
        self.clip = float(cfg["clip_grad_norm"])
        self.b1 = float(cfg["optimizer_adam_beta1"])
        self.b2 = float(cfg["optimizer_adam_beta2"])
        self.eps = 1e-8
        self.wd = float(cfg["weight_decay"])
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """Updates the parameters; returns the clipped gradients (what the
        moments take)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        grads = [g * scale for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        c1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            p.add_(upd * -lr)
        return grads


def train_step(model: nn.Module, opt: AdamW, batch: Dict, phase: Phase,
               cfg: Any, noise: Dict[str, Any]):
    """One optimizer step: (the losses, their sum, the clipped
    gradients)."""
    for p in opt.params:
        p.grad = None
    ret = model(**model_inputs(batch), noise=noise, infer=False,
                use_rq=phase.use_rq, forcing=phase.forcing,
                use_diff=phase.use_diff)
    losses = compute_losses(ret, batch, cfg, use_rq=phase.use_rq,
                            forcing=phase.forcing, use_diff=phase.use_diff)
    total = sum(losses[k] for k in sorted(losses))
    total.backward()
    grads = opt.step()
    return ({k: float(v.detach()) for k, v in losses.items()},
            float(total.detach()), grads)


def first_steps(model: nn.Module, cfg: Any, stacked: Dict, n_b: int,
                noise_fn, n: int = 3):
    """``n`` steps from the seeded weights: (initial parameters, losses
    per step, the first step's clipped gradients, the parameters after
    the last step)."""
    init_weights(model, cfg["seed"])
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    opt = AdamW(params, cfg)
    totals, first = [], None
    for t in range(n):
        j = batch_index(t, n_b, cfg["seed"])
        batch = {k: v[j] for k, v in stacked.items()}
        _, total, grads = train_step(model, opt, batch,
                                     phase_for_step(t, cfg), cfg,
                                     noise_fn(t))
        totals.append(total)
        if first is None:
            first = [g.detach().clone() for g in grads]
    after = [p.detach().clone() for p in params]
    return before, totals, first, after


def leaf_gaps(got: List[Optional[torch.Tensor]], want: List[torch.Tensor],
              keep: Optional[List[bool]] = None) -> List[float]:
    """Each leaf's gap between the two norms, over the reference leaf's
    norm or the median leaf's, whichever is larger (0 for a leaf left
    out by ``keep``)."""
    g = [float(torch.linalg.vector_norm(x.double())) for x in got]
    w = [float(torch.linalg.vector_norm(x.double())) for x in want]
    keep = keep or [True] * len(w)
    kept = [wi for wi, k in zip(w, keep) if k]
    med = float(np.median(kept)) if kept else 0.0
    return [abs(gi - wi) / max(wi, med, 1e-30) if k else 0.0
            for gi, wi, k in zip(g, w, keep)]
