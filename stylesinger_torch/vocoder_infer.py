"""Vocoder inference wrapper (port of ``HifiGAN_NSF`` in
``stylesinger_tpu/vocoder_infer.py``).

``HifiGAN_NSF`` turns a mel [T, M] (+ f0 [T]) into a waveform with the NSF
HiFi-GAN generator, in one call (:meth:`HifiGAN_NSF.spec2wav`) or in
crossfaded chunks of one shape (:meth:`HifiGAN_NSF.spec2wav_streaming`),
and applies the spectral-subtraction denoiser when ``vocoder_denoise_c``
> 0.  Its weights come from ``vocoder_ckpt`` (:func:`load_vocoder_state_dict`)
when that is set.  :func:`get_vocoder_cls` picks the wrapper that
``vocoder`` names (the JAX package's registry), ``HifiGAN_NSF`` or the
weightless ``GriffinLim``; the PWG and MelGAN wrappers are not ported.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Type, Union

import numpy as np
import torch

from stylesinger_torch.convert import (
    convert_hifigan, from_jax_params, load_torch_checkpoint,
)
from stylesinger_torch.dsp.denoise import denoise
from stylesinger_torch.dsp.griffin_lim import griffin_lim, mel_to_linear
from stylesinger_torch.inference import init_random_, resolve_device
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.hifigan import HifiGanGenerator
GAN_STATE_FILE = "gan_state.pt"   # fit_vocoder's whole GAN state
GENERATOR_FILE = "generator.pt"   # fit_vocoder's trained generator


def read_generator_file(path: str, map_location: Any = "cpu"
                        ) -> Dict[str, torch.Tensor]:
    """The generator's ``state_dict`` from one of the port's own files:
    ``generator.pt`` (the ``state_dict`` itself) or ``gan_state.pt`` (its
    ``gen`` entry)."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["gen"] if os.path.basename(path) == GAN_STATE_FILE \
        else payload


def load_vocoder_state_dict(cfg: Any, map_location: Any = "cpu"
                            ) -> Optional[Dict[str, torch.Tensor]]:
    """The trained generator's ``state_dict`` from ``cfg['vocoder_ckpt']``
    (JAX ``vocoder_infer.py::load_vocoder_params``):

    - a reference ``model_ckpt_steps_N.ckpt`` (its ``model_gen``, weight
      norm folded), or a directory of them, where the highest N wins;
    - the port's own ``generator.pt`` or ``gan_state.pt``
      (:func:`read_generator_file`).

    None when unset; a warning and None (random weights) when the path is
    missing or a directory holds no reference checkpoint."""
    ckpt = cfg.get("vocoder_ckpt", "")
    if not ckpt:
        return None
    if not os.path.exists(ckpt):
        print(f"| WARN: vocoder_ckpt {ckpt} not found; "
              "using random vocoder weights")
        return None
    path = ckpt
    if os.path.isdir(ckpt):
        refs = glob.glob(os.path.join(ckpt, "model_ckpt_steps_*.ckpt"))
        if not refs:
            print(f"| WARN: vocoder_ckpt dir {ckpt} has no reference "
                  "model_ckpt_steps_*.ckpt; using random vocoder weights")
            return None
        path = max(refs, key=lambda p: int(re.findall(
            r"steps_(\d+)", os.path.basename(p))[0]))
    if path.endswith(".ckpt"):
        return from_jax_params(convert_hifigan(load_torch_checkpoint(
            path, child="model_gen", map_location=map_location), cfg))
    return read_generator_file(path, map_location)


class HifiGAN_NSF:
    """mel [T, M] + f0 [T] -> wav [T * hop] with the NSF HiFi-GAN generator.

    ``model``: a generator with its weights; by default one with the
    weights of ``vocoder_ckpt`` (:func:`load_vocoder_state_dict`), or,
    where it is unset or missing, seeded random weights (``seed``; the JAX
    wrapper's flax init is random too).  Runs on ``device`` (``cuda``
    unless the caller asks for the CPU; raises when CUDA is absent).  Each call draws the
    generator's noise from a fresh ``Noise(seed)`` unless ``noise`` is
    given, as the JAX wrapper reuses one key for every call."""

    def __init__(self, cfg: Any, model: Optional[HifiGanGenerator] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        if model is None:
            model = HifiGanGenerator(cfg)
            sd = load_vocoder_state_dict(cfg, map_location=self.device)
            if sd is None:
                init_random_(model, torch.Generator().manual_seed(seed),
                             conv_std=0.01)
            else:
                model.load_state_dict(sd)
        self.model = model.to(self.device).eval()

    def _noise(self, noise):
        return noise if noise is not None else Noise(self.seed, self.device)

    def _run(self, mel: np.ndarray, f0: np.ndarray, noise) -> torch.Tensor:
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)[None]
        return self.model(t(mel), t(f0), self._noise(noise))[0]

    @torch.no_grad()
    def spec2wav(self, mel: np.ndarray, f0: Optional[np.ndarray] = None,
                 noise=None) -> np.ndarray:
        c = self.cfg
        if f0 is None:
            f0 = np.zeros(mel.shape[0], np.float32)
        wav = self._run(mel, np.asarray(f0)[: mel.shape[0]], noise)
        if c.get("vocoder_denoise_c", 0.0) > 0:
            wav = denoise(wav, c["vocoder_denoise_c"], n_fft=c["fft_size"],
                          hop_size=c["hop_size"], win_length=c["win_size"])
        return wav.cpu().numpy()

    @torch.no_grad()
    def spec2wav_streaming(self, mel: np.ndarray,
                           f0: Optional[np.ndarray] = None,
                           chunk_frames: int = 256, overlap_frames: int = 16,
                           noise=None) -> np.ndarray:
        """Chunks of ``chunk_frames`` frames that overlap by
        ``2 * overlap_frames``, crossfaded with linear ramps: every chunk
        has one shape whatever the length.  A mel of at most one chunk is
        :meth:`spec2wav`.  With ``noise`` given, the chunks draw from it in
        turn; by default each chunk draws from a fresh ``Noise(seed)``."""
        hop = self.cfg["hop_size"]
        t = mel.shape[0]
        if f0 is None:
            f0 = np.zeros(t, np.float32)
        if t <= chunk_frames:
            return self.spec2wav(mel, f0=f0, noise=noise)
        step = chunk_frames - 2 * overlap_frames
        out = np.zeros(t * hop, np.float32)
        weight = np.zeros(t * hop, np.float32)
        fade = np.ones(chunk_frames * hop, np.float32)
        ramp = np.linspace(0.0, 1.0, overlap_frames * hop, dtype=np.float32)
        fade[: overlap_frames * hop] = ramp
        fade[-overlap_frames * hop:] = ramp[::-1]
        pos = 0
        while pos < t:
            s = min(pos, t - chunk_frames)
            wav_c = self._run(mel[s: s + chunk_frames],
                              f0[s: s + chunk_frames], noise).cpu().numpy()
            o = s * hop
            out[o: o + len(wav_c)] += wav_c * fade[: len(wav_c)]
            weight[o: o + len(wav_c)] += fade[: len(wav_c)]
            if s + chunk_frames >= t:
                break
            pos = s + step
        return out / np.maximum(weight, 1e-8)


class GriffinLim:
    """DSP fallback with no weights: the mel's approximate linear
    magnitude (``mel_to_linear``) and 30 Griffin-Lim iterations, on
    ``device``.  The initial phases come from ``torch.Generator(seed)``
    unless ``spec2wav`` is given ``angles`` (JAX's wrapper draws them from
    ``PRNGKey(0)``)."""

    def __init__(self, cfg: Any, device: Union[str, torch.device] = "cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed

    @torch.no_grad()
    def spec2wav(self, mel: np.ndarray, angles=None, **kwargs) -> np.ndarray:
        c = self.cfg
        mag = mel_to_linear(
            torch.as_tensor(np.asarray(mel, np.float32), device=self.device),
            sample_rate=c["audio_sample_rate"], n_fft=c["fft_size"],
            n_mels=c["audio_num_mel_bins"], fmin=c["fmin"], fmax=c["fmax"])
        if angles is not None:
            angles = torch.as_tensor(np.asarray(angles))
        return griffin_lim(
            mag, n_fft=c["fft_size"], hop_size=c["hop_size"],
            win_length=c["win_size"], angles=angles,
            generator=torch.Generator().manual_seed(self.seed)
        ).cpu().numpy()


VOCODERS: Dict[str, Type] = {"HifiGAN_NSF": HifiGAN_NSF,
                             "GriffinLim": GriffinLim}
# registered in the JAX package, not ported yet: the ROADMAP item of each
UNPORTED_VOCODERS = {"PWG": "queue 1, item 9", "MelGAN": "queue 1, item 9"}


def get_vocoder_cls(cfg: Any) -> Type:
    """The wrapper class that ``cfg['vocoder']`` names."""
    name = cfg["vocoder"]
    if name in UNPORTED_VOCODERS:
        raise NotImplementedError(
            f"stylesinger_torch does not port the {name} vocoder yet "
            f"(ROADMAP.md {UNPORTED_VOCODERS[name]})")
    return VOCODERS[name]
