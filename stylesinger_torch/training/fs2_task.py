"""Train steps of the FastSpeech2 and PitchExtractor families (port of
``stylesinger_tpu/training/fs2_task.py``).

- FastSpeech2: the mel losses (``mel_loss``), the duration losses and,
  with ``use_pitch_embed`` and ``pitch_type: frame``, the f0 / uv losses;
- PitchExtractor: the f0 / uv losses of :func:`models.pe.pe_loss`.

JAX's ``make_*_train_step(model, cfg)`` take the flax module; here the
model is the ``TrainState``'s.  Each step is one update of
``training/step.py``'s :class:`Optimizer` (optax's AdamW under
``make_optimizer``'s schedule) on the sum of the losses.  Dropout is on, as in JAX's steps; its noise comes from the
step's own seeded source (``step_noise``'s ``dropout`` stream, where JAX
folds the step into its key) unless the caller passes ``drop``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from stylesinger_torch.models.pe import pe_loss
from stylesinger_torch.training.losses import (
    duration_losses, f0_uv_losses, mel_losses,
)
from stylesinger_torch.training.step import (
    TrainState, init_state, step_noise, total_loss,
)

Step = Callable[..., Dict[str, torch.Tensor]]


def fs2_losses(ret: Dict, batch: Dict, cfg: Any) -> Dict[str, torch.Tensor]:
    """FastSpeech2Task's losses of one pass."""
    losses = dict(mel_losses(ret["mel_out"], batch["mels"], cfg["mel_loss"]))
    losses.update(duration_losses(ret["dur"], batch["mel2ph"],
                                  batch["txt_tokens"], cfg,
                                  is_sil=batch.get("is_sil")))
    if cfg["use_pitch_embed"] and cfg["pitch_type"] == "frame":
        nonpadding = (batch["mel2ph"] > 0).to(ret["mel_out"].dtype)
        losses.update(f0_uv_losses(ret["pitch_pred"], batch["f0"],
                                   batch["uv"], nonpadding, cfg))
    return losses


def _make_step(cfg: Any, forward_losses) -> Step:
    """A step of ``state.model`` on the losses ``forward_losses(model,
    batch, drop)`` gives."""
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   drop=None) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (tensors on the model's device);
        returns the losses and ``total_loss``, detached."""
        if drop is None:
            drop = step_noise(cfg["seed"], state.step,
                              state.device)["dropout"]
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        losses = forward_losses(state.model, batch, drop)
        total = total_loss(losses)
        total.backward()
        state.opt.step(params, [p.grad for p in params])
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return out

    return train_step


def make_fs2_train_step(cfg: Any) -> Step:
    """FastSpeech2's step: model(txt, mel2ph, spk, f0, uv, energy) -> the
    mel, with the losses of :func:`fs2_losses`."""

    def forward_losses(model, batch, drop):
        ret = model(batch["txt_tokens"], batch["mel2ph"],
                    batch.get("spk_embed"), batch["f0"], batch["uv"],
                    batch.get("energy"), infer=False, drop=drop)
        return fs2_losses(ret, batch, cfg)

    return _make_step(cfg, forward_losses)


def init_fs2_state(model, cfg: Any, seed: Optional[int] = None
                   ) -> TrainState:
    """Seeded random weights for ``model`` and a fresh optimizer."""
    return init_state(model, cfg, seed)


def make_pe_train_step(cfg: Any) -> Step:
    """The PitchExtractor's step: mel -> (f0, uv)."""

    def forward_losses(model, batch, drop):
        ret = model(batch["mels"], drop=drop)
        return pe_loss(ret, batch["f0"], batch["uv"], cfg)

    return _make_step(cfg, forward_losses)
