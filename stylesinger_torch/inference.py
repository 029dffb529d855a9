"""End-to-end zero-shot synthesis (port of ``stylesinger_tpu/inference.py``).

ref wav -> log-mel (mel kernel) + F0 (autocorrelation tracker) + speaker and
emotion d-vectors (GE2E encoders); phones + notes -> ``StyleSinger``
(durations -> RSA style -> pitch -> decoder, ``models/stylesinger.py``) ->
NSF HiFi-GAN (the MRF kernel on the blocked stages it takes,
``models/hifigan.py``) -> wav.

Weights: :meth:`StyleSingerInfer.load_params` loads the acoustic model from
a training run's work dir, a ``TrainState`` or a reference ``.ckpt``; the
vocoder and the two encoders load from ``vocoder_ckpt``,
``speaker_encoder_path`` and ``emotion_encoder_path`` when the instance is
built.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU it
raises rather than fall back to the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.config import Config
from stylesinger_torch.convert import (
    convert_stylesinger, from_jax_params, load_ge2e_checkpoint,
    load_torch_checkpoint,
)
from stylesinger_torch.dsp.mel import load_wav, wav2spec
from stylesinger_torch.dsp.pitch import extract_pitch, norm_interp_f0_np
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.encoders import UtteranceEncoder, preprocess_wav
from stylesinger_torch.models.hifigan import HifiGanGenerator
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.text import TokenTextEncoder, build_token_encoder
from stylesinger_torch.utils import profiling


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return device


def _fit_bucket(n: int, buckets) -> int:
    """Smallest bucket >= n; n itself when nothing fits."""
    fits = [b for b in buckets if b >= n]
    return min(fits) if fits else n


def init_random_(module: nn.Module, generator: torch.Generator,
                 conv_std: Optional[float] = None) -> None:
    """Seeded random weights: matrices N(0, 1/fan_in) (conv kernels
    N(0, conv_std) when given), biases 0, norm scales 1, codebooks N(0, 1)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                std = conv_std if (conv_std and p.ndim == 3) \
                    else p[0].numel() ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif name.endswith("bias") or "bias_" in name:
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in module.named_buffers():
            if ".codebook_" in name and name.endswith(".embedding"):
                b.copy_(torch.randn(b.shape, generator=generator))


class StyleSingerInfer:
    """Zero-shot synthesis with one acoustic model, vocoder and pair of
    d-vector encoders on ``device``.

    Every module holds its weights from construction on: the vocoder and
    the encoders those of ``vocoder_ckpt``, ``speaker_encoder_path`` and
    ``emotion_encoder_path`` where these are set (:meth:`_init_vocoder`,
    :meth:`_init_encoders`), everything else its constructor's random
    weights until :meth:`init_random` or :meth:`load_params`.  Nothing is
    initialized lazily, so inference never re-randomizes what
    :meth:`load_params` loaded (what the JAX package's ``_init_missing``
    guards)."""

    def __init__(self, cfg: Config, phone_list: Optional[Sequence[str]] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ph_encoder = self._build_ph_encoder(phone_list)
        self.model = StyleSinger(cfg, len(self.ph_encoder))
        self.vocoder = HifiGanGenerator(cfg)
        self.spk_encoder = UtteranceEncoder()
        self.emo_encoder = UtteranceEncoder()
        for m in self.modules():
            m.to(self.device).eval()
        # the modules whose weights came from a configured file
        self.from_files = self._init_vocoder() | self._init_encoders()

    def modules(self) -> List[nn.Module]:
        return [self.model, self.vocoder, self.spk_encoder, self.emo_encoder]

    def _build_ph_encoder(self, phone_list) -> TokenTextEncoder:
        """The given phones, else ``<binary_data_dir>/phone_set.json``, else
        the letters a-z (as the JAX package does)."""
        if phone_list is None:
            fn = os.path.join(self.cfg["binary_data_dir"], "phone_set.json")
            if os.path.exists(fn):
                with open(fn) as f:
                    phone_list = json.load(f)
            else:
                phone_list = [chr(ord("a") + i) for i in range(26)]
        return build_token_encoder(phone_list)

    def init_random(self, seed: Optional[int] = None) -> None:
        """Random weights from ``torch.Generator(seed)`` (default: the
        config's ``seed``) for the acoustic model, and for the vocoder and
        each encoder whose weights did not come from a configured file
        (those keep them); the vocoder's convs use the JAX init's
        N(0, 0.01)."""
        g = torch.Generator().manual_seed(
            int(self.cfg["seed"] if seed is None else seed))
        init_random_(self.model, g)
        for name, conv_std in (("vocoder", 0.01), ("spk_encoder", None),
                               ("emo_encoder", None)):
            if name not in self.from_files:
                init_random_(getattr(self, name), g, conv_std)

    def _init_vocoder(self) -> set:
        """The trained generator of ``vocoder_ckpt``
        (``vocoder_infer.py::load_vocoder_state_dict``, which warns when
        the path is missing); ``{"vocoder"}`` when it loaded, else an
        empty set."""
        from stylesinger_torch.vocoder_infer import load_vocoder_state_dict

        sd = load_vocoder_state_dict(self.cfg, map_location=self.device)
        if sd is None:
            return set()
        self.vocoder.load_state_dict(sd)
        return {"vocoder"}

    def _init_encoders(self) -> set:
        """Pretrained GE2E weights for the speaker and emotion encoders from
        ``speaker_encoder_path`` / ``emotion_encoder_path`` where the files
        exist (the reference's zero-shot style transfer depends on them),
        with a warning for a path that does not exist; the names of the
        encoders that loaded."""
        loaded = set()
        for name, key, what in (
                ("spk_encoder", "speaker_encoder_path", "speaker"),
                ("emo_encoder", "emotion_encoder_path", "emotion")):
            path = self.cfg.get(key) or ""
            if path and os.path.exists(path):
                getattr(self, name).load_state_dict(from_jax_params(
                    load_ge2e_checkpoint(path, map_location=self.device)))
                loaded.add(name)
            elif path:
                print(f"| WARN: {key} {path} not found; using random "
                      f"{what}-encoder weights")
        return loaded

    def load_params(self, state_or_dir: Any) -> None:
        """The acoustic model's weights (its parameters and RQ buffers) from
        a ``TrainState``, from a work dir (the latest
        ``ckpt/model_ckpt_steps_<N>.pt`` that ``Trainer.fit`` wrote; the
        optimizer's state is not read), or from a reference
        ``model_ckpt_steps_N.ckpt`` file (its ``model`` child, converted
        by :func:`convert_stylesinger`).  Raises ``FileNotFoundError`` on a
        work dir that holds no checkpoint."""
        if not isinstance(state_or_dir, (str, os.PathLike)):
            self.model.load_state_dict(state_or_dir.model.state_dict())
            return
        path = os.fspath(state_or_dir)
        if path.endswith(".ckpt"):
            sd = load_torch_checkpoint(path, map_location=self.device)
            self.model.load_state_dict(from_jax_params(
                convert_stylesinger(sd, self.cfg)))
            return
        from stylesinger_torch.training.checkpoint import (
            latest_checkpoint, load_payload,
        )

        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoint under {path}/ckpt; refusing to synthesize "
                "from random weights (train first, or pass a reference "
                ".ckpt file)")
        self.model.load_state_dict(load_payload(latest[1],
                                                self.device)["model"])

    # --------------------------------------------------------- preprocess
    def preprocess_input(self, inp: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
        """Phones / notes / durations / note types + a reference clip (a
        path or a 1-D array at ``audio_sample_rate``) -> model inputs [1, ...]
        on the device."""
        with profiling.span("frontend", n=1):
            return self._preprocess(inp)

    def _preprocess(self, inp: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        c = self.cfg
        ph = inp["ph"] if "ph" in inp else inp["text"]
        notes = inp["notes"]
        note = [int(x) for x in notes.split(" ")] \
            if isinstance(notes, str) else list(notes)
        durs = inp["notes_duration"]
        note_dur = [float(x) for x in durs.split(" ")] \
            if isinstance(durs, str) else list(durs)
        ref = inp["ref_audio"]
        wav48 = load_wav(ref, c["audio_sample_rate"]) \
            if isinstance(ref, str) else np.asarray(ref, np.float32)

        with profiling.span("frontend.mel"):
            spec = wav2spec(wav48, self.device,
                            sample_rate=c["audio_sample_rate"],
                            n_fft=c["fft_size"], hop_size=c["hop_size"],
                            win_length=c["win_size"],
                            n_mels=c["audio_num_mel_bins"], fmin=c["fmin"],
                            fmax=c["fmax"])
        n_mel = spec["mel"].shape[0]
        with profiling.span("frontend.pitch"):
            f0_raw = extract_pitch(spec["wav"], hop_size=c["hop_size"],
                                   sample_rate=c["audio_sample_rate"],
                                   device=self.device)[:n_mel]
            f0_raw = np.pad(f0_raw, (0, n_mel - len(f0_raw)))
            ref_f0, _ = norm_interp_f0_np(
                f0_raw, pitch_norm=c["pitch_norm"], use_uv=c["use_uv"],
                f0_mean=c["f0_mean"], f0_std=c["f0_std"])

        wav16 = preprocess_wav(spec["wav"], c["audio_sample_rate"])
        spk_wav = spec["wav"].astype(np.float32) \
            if c.get("spk_embed_at_native_rate", True) else wav16
        with profiling.span("frontend.embed"):
            spk = self.spk_encoder.embed_utterance(spk_wav, project=True)
            emo = self.emo_encoder.embed_utterance(wav16, project=False)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)[None]

        return dict(
            txt_tokens=t(self.ph_encoder.encode(ph), torch.long),
            ref_mels=spec["mel"][None], ref_f0=t(ref_f0), spk_embed=t(spk),
            emo_embed=t(emo), note=t(note, torch.long),
            note_dur=t(note_dur), note_type=t(inp["note_types"], torch.long))

    # -------------------------------------------------------------- infer
    @torch.no_grad()
    def forward_model(self, batch: Dict[str, torch.Tensor],
                      max_frames: Optional[int] = None,
                      noise=None) -> Dict[str, np.ndarray]:
        """One request -> {'wav', 'mel', 'f0'} cropped to the predicted
        length.  ``noise`` defaults to a fresh ``Noise(cfg['seed'])``."""
        noise = noise if noise is not None else Noise(self.cfg["seed"],
                                                      self.device)
        ret = self.model(**batch, noise=noise, max_frames=max_frames)
        wav = self.vocoder(ret["mel_out"], ret["f0_denorm"], noise)
        n = int((ret["mel2ph"] > 0).sum(-1).max())
        return dict(wav=wav[0, : n * self.cfg["hop_size"]].cpu().numpy(),
                    mel=ret["mel_out"][0, :n].cpu().numpy(),
                    f0=ret["f0_denorm"][0, :n].cpu().numpy())

    def infer_once(self, inp: Dict[str, Any]) -> np.ndarray:
        return self.forward_model(self.preprocess_input(inp))["wav"]

    @torch.no_grad()
    def infer_batch(self, inps: Sequence[Dict[str, Any]], noise=None) -> list:
        """Pad all requests to shared buckets and run one acoustic forward;
        the vocoder then runs per request on its own length.  ``noise``
        defaults to a fresh ``Noise(cfg['seed'])`` for the acoustic model
        and for each request's vocoder call; when given, all of them draw
        from it in that order."""
        with profiling.span("infer_batch", n=len(inps)):
            return self._infer_batch(inps, noise)

    def _infer_batch(self, inps: Sequence[Dict[str, Any]], noise) -> list:
        batches = [self.preprocess_input(inp) for inp in inps]
        t_txt = _fit_bucket(max(b["txt_tokens"].shape[1] for b in batches),
                            self.cfg.get("token_buckets", ()))
        t_ref = _fit_bucket(max(b["ref_mels"].shape[1] for b in batches),
                            self.cfg.get("frame_buckets", ()))
        lengths = dict(txt_tokens=t_txt, note=t_txt, note_dur=t_txt,
                       note_type=t_txt, ref_mels=t_ref, ref_f0=t_ref)

        def pad(x, length):
            width = [0, 0] * (x.ndim - 2) + [0, length - x.shape[1]]
            return torch.nn.functional.pad(x, width)

        joint = {k: torch.cat([pad(b[k], lengths[k]) if k in lengths
                               else b[k] for b in batches])
                 for k in batches[0]}
        def fresh():
            return noise if noise is not None else Noise(self.cfg["seed"],
                                                         self.device)

        with profiling.span("acoustic", n=len(inps)):
            ret = self.model(**joint, noise=fresh())
        mel, f0 = ret["mel_out"], ret["f0_denorm"]
        n_frames = (ret["mel2ph"] > 0).sum(-1).tolist()
        outs = []
        for b, t in enumerate(n_frames):
            if t == 0:
                outs.append(dict(wav=np.zeros(0, np.float32),
                                 mel=mel[b, :0].cpu().numpy(),
                                 f0=f0[b, :0].cpu().numpy()))
                continue
            with profiling.span("vocoder", n=t * self.cfg["hop_size"]):
                wav = self.vocoder(mel[b: b + 1, :t], f0[b: b + 1, :t],
                                   fresh())[0]
            with profiling.span("download"):
                outs.append(dict(wav=wav.cpu().numpy(),
                                 mel=mel[b, :t].cpu().numpy(),
                                 f0=f0[b, :t].cpu().numpy()))
        return outs
