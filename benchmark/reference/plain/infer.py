"""The port's ``StyleSingerInfer`` inference path, frozen on the plain
modules: the phone encoder, ``preprocess_input`` (log-mel, F0, both
d-vectors) and ``infer_batch`` (one padded acoustic forward, then the
vocoder per request).  Weights are the caller's state dicts."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .diffusion import Noise
from .encoders import UtteranceEncoder, preprocess_wav
from .hifigan import HifiGanGenerator
from .mel import wav2spec
from .pitch import extract_pitch, norm_interp_f0_np
from .stylesinger import StyleSinger

RESERVED = ["<pad>", "<EOS>", "<UNK>"]


class PhoneEncoder:
    """Reserved ``<pad>``, ``<EOS>``, ``<UNK>`` (ids 0, 1, 2), then the
    phones sorted; an unknown phone reads ``<UNK>``."""

    def __init__(self, phones: Sequence[str]):
        vocab = RESERVED + [p for p in sorted(set(phones))
                            if p not in RESERVED]
        self.ids = {p: i for i, p in enumerate(vocab)}

    def __len__(self) -> int:
        return len(self.ids)

    def encode(self, s: str):
        return [self.ids.get(t, 2) for t in s.strip().split()]


def _fit_bucket(n: int, buckets) -> int:
    fits = [b for b in buckets if b >= n]
    return min(fits) if fits else n


class PlainInfer:
    """Attributes as the port's instance has them (``model``, ``vocoder``,
    ``spk_encoder``, ``emo_encoder``, ``ph_encoder``), so that the same
    hooks reach either.  ``dft_dtype``: the log-mel's DFT (the mel
    kernel's f64; the control's f32)."""

    def __init__(self, cfg: Dict[str, Any], phones: Sequence[str],
                 device: torch.device,
                 dft_dtype: torch.dtype = torch.float64):
        self.cfg = cfg
        self.dft_dtype = dft_dtype
        self.device = torch.device(device)
        self.ph_encoder = PhoneEncoder(phones)
        with torch.device(self.device):
            self.model = StyleSinger(cfg, len(self.ph_encoder))
            self.vocoder = HifiGanGenerator(cfg)
            self.spk_encoder = UtteranceEncoder()
            self.emo_encoder = UtteranceEncoder()
        for m in self.modules():
            m.eval()

    def modules(self):
        return [self.model, self.vocoder, self.spk_encoder, self.emo_encoder]

    def load(self, states: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for name, sd in states.items():
            getattr(self, name).load_state_dict(sd)

    def preprocess_input(self, inp: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
        c = self.cfg
        wav48 = np.asarray(inp["ref_audio"], np.float32)
        spec = wav2spec(wav48, self.device, sample_rate=c["audio_sample_rate"],
                        n_fft=c["fft_size"], hop_size=c["hop_size"],
                        win_length=c["win_size"],
                        n_mels=c["audio_num_mel_bins"], fmin=c["fmin"],
                        fmax=c["fmax"], dft_dtype=self.dft_dtype)
        n_mel = spec["mel"].shape[0]
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
        spk = self.spk_encoder.embed_utterance(spk_wav, project=True)
        emo = self.emo_encoder.embed_utterance(wav16, project=False)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)[None]

        return dict(
            txt_tokens=t(self.ph_encoder.encode(inp["ph"]), torch.long),
            ref_mels=spec["mel"][None], ref_f0=t(ref_f0), spk_embed=t(spk),
            emo_embed=t(emo), note=t(list(inp["notes"]), torch.long),
            note_dur=t(list(inp["notes_duration"])),
            note_type=t(inp["note_types"], torch.long))

    def join(self, batches):
        """The requests padded to shared buckets, as one batch."""
        t_txt = _fit_bucket(max(b["txt_tokens"].shape[1] for b in batches),
                            self.cfg.get("token_buckets", ()))
        t_ref = _fit_bucket(max(b["ref_mels"].shape[1] for b in batches),
                            self.cfg.get("frame_buckets", ()))
        lengths = dict(txt_tokens=t_txt, note=t_txt, note_dur=t_txt,
                       note_type=t_txt, ref_mels=t_ref, ref_f0=t_ref)

        def pad(x, length):
            width = [0, 0] * (x.ndim - 2) + [0, length - x.shape[1]]
            return torch.nn.functional.pad(x, width)

        return {k: torch.cat([pad(b[k], lengths[k]) if k in lengths
                              else b[k] for b in batches])
                for k in batches[0]}

    @torch.no_grad()
    def infer_batch(self, inps, noise=None) -> list:
        batches = [self.preprocess_input(inp) for inp in inps]
        joint = self.join(batches)

        def fresh():
            return noise if noise is not None else Noise(self.cfg["seed"],
                                                         self.device)

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
            wav = self.vocoder(mel[b: b + 1, :t], f0[b: b + 1, :t],
                               fresh())[0]
            outs.append(dict(wav=wav.cpu().numpy(),
                             mel=mel[b, :t].cpu().numpy(),
                             f0=f0[b, :t].cpu().numpy()))
        return outs
