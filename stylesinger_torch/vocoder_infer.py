"""Vocoder inference wrapper (port of ``HifiGAN_NSF`` in
``stylesinger_tpu/vocoder_infer.py``).

``HifiGAN_NSF`` turns a mel [T, M] (+ f0 [T]) into a waveform with the NSF
HiFi-GAN generator, in one call (:meth:`HifiGAN_NSF.spec2wav`) or in
crossfaded chunks of one shape (:meth:`HifiGAN_NSF.spec2wav_streaming`),
and applies the spectral-subtraction denoiser when ``vocoder_denoise_c``
> 0.  Its weights come from ``vocoder_ckpt`` (:func:`load_vocoder_state_dict`)
when that is set.  :func:`get_vocoder_cls` picks the wrapper that
``vocoder`` names (the JAX package's registry): ``HifiGAN_NSF``, the
weightless ``GriffinLim``, or the alternative ``PWG`` and ``MelGAN``, whose
weights come from an official ParallelWaveGAN checkpoint or a reference
task checkpoint that ``vocoder_ckpt`` names (:func:`_find_legacy_ckpt`).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Type, Union

import numpy as np
import torch

from stylesinger_torch.convert import (
    convert_hifigan, from_jax_params, load_melgan_checkpoint,
    load_pwg_checkpoint, load_torch_checkpoint,
)
from stylesinger_torch.dsp.denoise import denoise
from stylesinger_torch.dsp.griffin_lim import griffin_lim, mel_to_linear
from stylesinger_torch.dsp.pitch import f0_to_coarse
from stylesinger_torch.inference import init_random_, resolve_device
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.hifigan import HifiGanGenerator
from stylesinger_torch.models.legacy_vocoders import (
    MelGANGenerator, ParallelWaveGANGenerator,
)
from stylesinger_torch.utils import profiling

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
        with profiling.span("vocoder.upload"):
            mel_t, f0_t = t(mel), t(f0)
        with profiling.span("vocoder",
                            n=mel.shape[0] * self.cfg["hop_size"]):
            return self.model(mel_t, f0_t, self._noise(noise))[0]

    @torch.no_grad()
    def spec2wav(self, mel: np.ndarray, f0: Optional[np.ndarray] = None,
                 noise=None) -> np.ndarray:
        with profiling.span("spec2wav", n=1):
            c = self.cfg
            if f0 is None:
                f0 = np.zeros(mel.shape[0], np.float32)
            wav = self._run(mel, np.asarray(f0)[: mel.shape[0]], noise)
            if c.get("vocoder_denoise_c", 0.0) > 0:
                wav = denoise(wav, c["vocoder_denoise_c"],
                              n_fft=c["fft_size"], hop_size=c["hop_size"],
                              win_length=c["win_size"])
            with profiling.span("vocoder.download"):
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


def _find_legacy_ckpt(base: str) -> tuple:
    """(checkpoint, feature stats, config.yaml), each a path or None, for
    ``vocoder_ckpt`` of the PWG / MelGAN wrappers: a file itself, or a
    directory holding official ``checkpoint-<N>steps.pkl`` files (with
    ``stats.h5`` or ``stats.npy`` and ``config.yaml``) or reference
    ``model_ckpt_steps_<N>.ckpt`` files, the highest N first."""
    if not base:
        return None, None, None
    if os.path.isfile(base):
        d, ckpt = os.path.dirname(base), base
    elif os.path.isdir(base):
        d = base
        official = glob.glob(os.path.join(d, "checkpoint-*steps.pkl"))
        custom = glob.glob(os.path.join(d, "model_ckpt_steps_*.ckpt"))
        if official:
            ckpt = max(official, key=lambda p: int(re.findall(
                r"checkpoint-(\d+)steps", p)[0]))
        elif custom:
            ckpt = max(custom, key=lambda p: int(re.findall(
                r"steps_(\d+)", p)[0]))
        else:
            return None, None, None
    else:
        return None, None, None
    stats = next((p for p in (os.path.join(d, "stats.h5"),
                              os.path.join(d, "stats.npy"))
                  if os.path.exists(p)), None)
    cfgp = os.path.join(d, "config.yaml")
    return ckpt, stats, cfgp if os.path.exists(cfgp) else None


class _LegacyVocoder:
    """What the PWG and MelGAN wrappers share: the device, the feature
    stats of an official checkpoint (the input mel is normalized by them),
    the generator's weights, and the hop-size check."""

    name = ""

    def _load(self, cfg: Any, loader) -> Optional[tuple]:
        """(state_dict, stats, generator hyperparameters) of
        ``vocoder_ckpt``; None, with JAX's warning where it is set but
        holds no checkpoint."""
        ckpt, stats_p, cfg_p = _find_legacy_ckpt(cfg.get("vocoder_ckpt", ""))
        if ckpt is None:
            if cfg.get("vocoder_ckpt", ""):
                print(f"| WARN: vocoder_ckpt {cfg['vocoder_ckpt']} has no "
                      f"{self.name} checkpoint; using random weights")
            return None
        variables, stats, gp = loader(ckpt, stats_p, cfg_p)
        print(f"| Loaded {self.name} vocoder from {ckpt}"
              + (" (+feature stats)" if stats else ""))
        return from_jax_params(variables), stats, gp

    def _place(self, model, sd, seed: int) -> None:
        if sd is None:
            init_random_(model, torch.Generator().manual_seed(seed),
                         conv_std=0.01)
        else:
            model.load_state_dict(sd)
        self.model = model.to(self.device).eval()
        if model.hop != int(self.cfg["hop_size"]):
            print(f"| WARN: {self.name} upsample scales multiply to "
                  f"{model.hop} but the pipeline hop_size is "
                  f"{self.cfg['hop_size']}; wav lengths will disagree with "
                  "frames*hop_size")

    def _mel(self, mel: np.ndarray) -> torch.Tensor:
        c = np.asarray(mel, np.float32)
        if self.stats is not None:
            c = (c - self.stats["mean"]) / self.stats["scale"]
        return torch.as_tensor(c, device=self.device)[None]


class PWG(_LegacyVocoder):
    """Parallel WaveGAN: mel [T, M] (+ f0 [T] for a generator with a pitch
    embedding) -> wav [T * hop].

    The generator's shape: the ``pwg_*`` keys of ``cfg`` (defaults 30
    layers, 3 stacks, 64 / 128 / 64 channels, aux context window 2, no
    pitch embedding), overlaid by what the checkpoint shows
    (:func:`convert.load_pwg_checkpoint`); its weights those of
    ``vocoder_ckpt``, else seeded random ones (``seed``).  Each call draws
    the noise from a fresh ``Noise(seed)`` unless ``noise`` is given."""

    name = "PWG"

    def __init__(self, cfg: Any, device: Union[str, torch.device] = "cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.stats = None
        gen_kw: Dict[str, Any] = {
            "layers": int(cfg.get("pwg_layers", 30)),
            "stacks": int(cfg.get("pwg_stacks", 3)),
            "residual_channels": int(cfg.get("pwg_residual_channels", 64)),
            "gate_channels": int(cfg.get("pwg_gate_channels", 128)),
            "skip_channels": int(cfg.get("pwg_skip_channels", 64)),
            "aux_context_window": int(cfg.get("pwg_aux_context_window", 2)),
            "use_pitch_embed": bool(cfg.get("pwg_use_pitch_embed", False)),
        }
        loaded = self._load(cfg, load_pwg_checkpoint)
        sd = None
        if loaded is not None:
            sd, self.stats, gp = loaded
            up = gp.get("upsample_params", {})
            for key in ("layers", "stacks", "residual_channels",
                        "gate_channels", "skip_channels"):
                gen_kw[key] = int(gp.get(key, gen_kw[key]))
            gen_kw["aux_context_window"] = int(up.get(
                "aux_context_window", gp.get("aux_context_window",
                                             gen_kw["aux_context_window"])))
            gen_kw["use_pitch_embed"] = bool(gp.get(
                "use_pitch_embed", gen_kw["use_pitch_embed"]))
            if "stacks" not in gp and "pwg_stacks" not in cfg:
                # the dilation schedule leaves no trace in the weights: a
                # wrong default loads cleanly and corrupts the audio
                print("| WARN: PWG 'stacks' not in config.yaml and no "
                      f"pwg_stacks in cfg; assuming {gen_kw['stacks']} "
                      "(dilation schedule is NOT recoverable from the "
                      "weights - set pwg_stacks if training differed)")
            if up.get("upsample_scales"):
                self.cfg = cfg = type(cfg)(cfg)
                cfg["pwg_upsample_scales"] = list(up["upsample_scales"])
        self._place(ParallelWaveGANGenerator(cfg, **gen_kw), sd, seed)

    @torch.no_grad()
    def spec2wav(self, mel: np.ndarray, f0: Optional[np.ndarray] = None,
                 noise=None, **kwargs) -> np.ndarray:
        c = self._mel(mel)
        pitch = None
        if self.model.use_pitch_embed:
            f0 = np.zeros(c.shape[1], np.float32) if f0 is None else f0
            pitch = f0_to_coarse(torch.as_tensor(
                np.asarray(f0, np.float32)[: c.shape[1]],
                device=self.device))[None]
        noise = noise if noise is not None else Noise(self.seed, self.device)
        return self.model(c, noise, pitch)[0].cpu().numpy()


class MelGAN(_LegacyVocoder):
    """MelGAN: mel [T, M] -> wav [T * hop].  A checkpoint sets the
    generator's width and upsample rates (read from its weights); without
    one they are 512 and ``upsample_rates``, with seeded random weights."""

    name = "MelGAN"

    def __init__(self, cfg: Any, device: Union[str, torch.device] = "cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stats = None
        loaded = self._load(cfg, lambda ck, st, _: load_melgan_checkpoint(
            ck, stats_path=st))
        sd, gen_kw = None, {}
        if loaded is not None:
            sd, self.stats, gp = loaded
            gen_kw = {"base_channels": gp["base_channels"]}
            self.cfg = cfg = type(cfg)(cfg)
            cfg["melgan_upsample_scales"] = list(gp["upsample_scales"])
        self._place(MelGANGenerator(cfg, **gen_kw), sd, seed)

    @torch.no_grad()
    def spec2wav(self, mel: np.ndarray, **kwargs) -> np.ndarray:
        return self.model(self._mel(mel))[0].cpu().numpy()


VOCODERS: Dict[str, Type] = {"HifiGAN_NSF": HifiGAN_NSF,
                             "GriffinLim": GriffinLim, "PWG": PWG,
                             "MelGAN": MelGAN}


def get_vocoder_cls(cfg: Any) -> Type:
    """The wrapper class that ``cfg['vocoder']`` names."""
    return VOCODERS[cfg["vocoder"]]
