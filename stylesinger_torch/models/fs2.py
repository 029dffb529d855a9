"""FastSpeech2 (port of ``stylesinger_tpu/models/fs2.py``): the phone
encoder, durations -> ``mel2ph`` with a static length, the phone-to-frame
gather, the pitch (``frame``, ``ph`` and ``cwt``) and energy embeddings,
the decoder and the mel head; ``grad_scale`` and the helpers StyleSinger
shares with it.

Dropout follows ``models/common.py``: ``drop`` is the step's dropout noise
source, or None for the deterministic pass (JAX's ``deterministic``, which
defaults to ``infer``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stylesinger_torch.dsp.cwt import cwt2f0
from stylesinger_torch.dsp.pitch import denorm_f0, f0_to_coarse, norm_f0
from stylesinger_torch.models.common import (
    Dense, DurationPredictor, Embedding, FastspeechDecoder, FastspeechEncoder,
    PitchPredictor, length_regulator,
)

DVEC_DIM = 256   # d-vector width of the GE2E encoders


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The value of ``x`` with its gradient scaled by ``scale``."""
    if scale == 1.0:
        return x
    return x.detach() + scale * (x - x.detach())


def expand_states(h: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """Phone-level [B, T_txt, H] -> frames [B, T_mel, H]; mel2ph is
    1-based and index 0 reads a zero vector."""
    h = F.pad(h, (0, 0, 1, 0))
    return torch.gather(h, 1, mel2ph[..., None].expand(-1, -1, h.shape[-1]))


def predict_mel2ph(log_dur: torch.Tensor, src_nonpadding: torch.Tensor,
                   max_frames: int) -> torch.Tensor:
    """Predicted log-durations [B, T_txt] -> mel2ph [B, max_frames]."""
    return length_regulator(DurationPredictor.out2dur(log_dur),
                            1 - src_nonpadding, max_frames)


class CwtStats(nn.Module):
    """flax ``nn.Sequential([Dense(h), relu, Dense(h), relu, Dense(2)])``:
    the per-utterance (mean, std) of the log-f0 from the first phone."""

    def __init__(self, hidden: int):
        super().__init__()
        self.layers_0 = Dense(hidden, hidden)
        self.layers_2 = Dense(hidden, hidden)
        self.layers_4 = Dense(hidden, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_4(F.relu(self.layers_2(F.relu(self.layers_0(x)))))


class FastSpeech2(nn.Module):
    """Phones [B, T_txt] (+ speaker, f0, uv, energy) -> a dict with
    ``mel_out`` [B, T_mel, out_dims], ``dur``, ``mel2ph``, ``decoder_inp``,
    ``f0_denorm`` and the pitch / energy predictions."""

    def __init__(self, cfg: Any, vocab_size: int, out_dims: int = 80):
        super().__init__()
        c = self.cfg = cfg
        h = c["hidden_size"]
        self.encoder = FastspeechEncoder(
            vocab_size, h, c["enc_layers"], c["enc_ffn_kernel_size"],
            num_heads=c["num_heads"], dropout=c["dropout"],
            rel_pos=bool(c.get("rel_pos", False)))
        self.decoder = FastspeechDecoder(
            h, c["dec_layers"], c["dec_ffn_kernel_size"],
            num_heads=c["num_heads"], dropout=c["dropout"])
        self.mel_out = Dense(h, out_dims)
        self.use_spk = bool(c["use_spk_embed"] or c["use_spk_id"])
        self.use_spk_id = bool(not c["use_spk_embed"] and c["use_spk_id"])
        if c["use_spk_embed"]:
            self.spk_embed_proj = Dense(DVEC_DIM, h)
        elif c["use_spk_id"]:
            self.spk_embed_proj = Embedding(c["num_spk"] + 1, h)
        ph = c["predictor_hidden"] if c["predictor_hidden"] > 0 else h
        self.dur_predictor = DurationPredictor(
            h, ph, n_layers=c["dur_predictor_layers"],
            kernel_size=c["dur_predictor_kernel"],
            dropout=c["predictor_dropout"])

        def predictor(odim):
            return PitchPredictor(h, ph, odim=odim,
                                  n_layers=c["predictor_layers"],
                                  kernel_size=c["predictor_kernel"],
                                  dropout=c["predictor_dropout"])

        if c["use_pitch_embed"]:
            self.pitch_embed = Embedding(300, h)
            if c["pitch_type"] == "cwt":
                self.cwt_predictor = predictor(11 if c["use_uv"] else 10)
                self.cwt_stats_layers = CwtStats(h)
            else:
                self.pitch_predictor = predictor(
                    2 if c["pitch_type"] == "frame" else 1)
        if c["use_energy_embed"]:
            self.energy_embed = Embedding(256, h)
            self.energy_predictor = predictor(1)

    def _f0_kw(self) -> Dict[str, Any]:
        c = self.cfg
        return dict(pitch_norm=c["pitch_norm"], f0_mean=c["f0_mean"],
                    f0_std=c["f0_std"])

    def add_dur(self, dur_inp, mel2ph, txt_tokens, ret, *, max_frames,
                drop=None):
        src_nonpadding = (txt_tokens > 0).to(torch.float32)
        dur_inp = grad_scale(dur_inp, self.cfg["predictor_grad"])
        log_dur = self.dur_predictor(dur_inp, src_nonpadding, drop)
        ret["dur"] = log_dur
        if mel2ph is None:
            dur = DurationPredictor.out2dur(log_dur)
            ret["dur_choice"] = dur
            mel2ph = length_regulator(dur, 1 - src_nonpadding, max_frames)
        ret["mel2ph"] = mel2ph
        return mel2ph

    def add_pitch(self, pitch_inp, f0, uv, mel2ph, ret, *, encoder_out,
                  drop=None):
        """The pitch embedding of the three variants: ``frame`` (f0 + uv per
        frame), ``cwt`` (10-scale wavelet spectrogram + per-utterance
        stats) and ``ph`` (phone-level f0 gathered to frames)."""
        c = self.cfg
        use_uv = c["use_uv"]
        tgt_nonpadding = (mel2ph > 0).to(torch.float32)
        pitch_inp = grad_scale(pitch_inp, c["predictor_grad"])
        if c["pitch_type"] == "cwt":
            cwt_out = self.cwt_predictor(pitch_inp, tgt_nonpadding, drop)
            ret["cwt"] = cwt_out
            stats = self.cwt_stats_layers(encoder_out[:, 0, :])
            mean = ret["f0_mean"] = stats[:, 0]
            std = ret["f0_std"] = stats[:, 1]
            if f0 is None:
                f0_hz = cwt2f0(cwt_out[:, :, :10], mean,
                               std * c.get("cwt_std_scale", 0.8))
                f0 = norm_f0(f0_hz, None, **self._f0_kw())
                if use_uv:
                    uv = (cwt_out[:, :, -1] > 0).to(torch.float32)
            f0_denorm = denorm_f0(f0, uv if use_uv else None,
                                  **self._f0_kw())
            ret["f0_denorm"] = f0_denorm
            return self.pitch_embed(f0_to_coarse(f0_denorm))
        if c["pitch_type"] == "ph":
            src_nonpadding = (encoder_out.abs().sum(-1) > 0).to(torch.float32)
            pitch_pred = self.pitch_predictor(
                grad_scale(encoder_out, c["predictor_grad"]), src_nonpadding,
                drop)
            ret["pitch_pred"] = pitch_pred
            if f0 is None:
                f0 = pitch_pred[:, :, 0]
            f0_denorm = denorm_f0(f0, None, **self._f0_kw())
            ret["f0_denorm"] = f0_denorm
            pitch = F.pad(f0_to_coarse(f0_denorm), (1, 0))
            return self.pitch_embed(torch.gather(pitch, 1, mel2ph))
        pitch_pred = self.pitch_predictor(pitch_inp, tgt_nonpadding, drop)
        ret["pitch_pred"] = pitch_pred
        if f0 is None:
            f0 = pitch_pred[:, :, 0]
            if use_uv:
                uv = (pitch_pred[:, :, 1] > 0).to(torch.float32)
        f0_denorm = denorm_f0(f0, uv if use_uv else None,
                              pitch_padding=mel2ph == 0, **self._f0_kw())
        ret["f0_denorm"] = f0_denorm
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def add_energy(self, inp, energy, ret, nonpadding, drop=None):
        inp = grad_scale(inp, self.cfg["predictor_grad"])
        pred = self.energy_predictor(inp, nonpadding, drop)[:, :, 0]
        ret["energy_pred"] = pred
        if energy is None:
            energy = pred
        bins = torch.div(energy * 256, 4, rounding_mode="floor").long()
        return self.energy_embed(torch.clamp(bins, 0, 255))

    def run_decoder(self, decoder_inp, tgt_nonpadding, drop=None):
        x = self.decoder(decoder_inp, tgt_nonpadding, drop)
        return self.mel_out(x) * tgt_nonpadding[..., None]

    def forward(self, txt_tokens: torch.Tensor,
                mel2ph: Optional[torch.Tensor] = None,
                spk_embed: Optional[torch.Tensor] = None,
                f0: Optional[torch.Tensor] = None,
                uv: Optional[torch.Tensor] = None,
                energy: Optional[torch.Tensor] = None,
                infer: bool = False, max_frames: Optional[int] = None,
                drop=None) -> Dict[str, torch.Tensor]:
        """``mel2ph`` None predicts the durations (inference); ``drop``
        None is the deterministic pass."""
        c = self.cfg
        if mel2ph is None and not infer:
            raise ValueError("FastSpeech2: training needs mel2ph")
        max_frames = c["max_frames"] if max_frames is None else max_frames
        ret: Dict[str, torch.Tensor] = {}
        encoder_out = self.encoder(txt_tokens, drop)
        src_nonpadding = (txt_tokens > 0).to(torch.float32)[:, :, None]
        spk = 0.0
        if self.use_spk:
            ids = spk_embed.long() if self.use_spk_id else spk_embed
            spk = self.spk_embed_proj(ids)[:, None, :]
        dur_inp = (encoder_out + spk) * src_nonpadding
        mel2ph = self.add_dur(dur_inp, mel2ph, txt_tokens, ret,
                              max_frames=max_frames, drop=drop)
        tgt_nonpadding = (mel2ph > 0).to(torch.float32)
        decoder_inp = expand_states(encoder_out, mel2ph)
        pitch_inp = (decoder_inp + spk) * tgt_nonpadding[..., None]
        if c["use_pitch_embed"]:
            decoder_inp = decoder_inp + self.add_pitch(
                pitch_inp, f0, uv, mel2ph, ret, encoder_out=encoder_out,
                drop=drop)
        if c["use_energy_embed"]:
            decoder_inp = decoder_inp + self.add_energy(
                pitch_inp, energy, ret, tgt_nonpadding, drop)
        decoder_inp = (decoder_inp + spk) * tgt_nonpadding[..., None]
        ret["decoder_inp"] = decoder_inp
        ret["mel_out"] = self.run_decoder(decoder_inp, tgt_nonpadding, drop)
        return ret
