"""StyleSinger acoustic model (port of ``stylesinger_tpu/models/stylesinger.py``).

FS2 phoneme encoder + note encoder -> spk/emo projection -> durations ->
static-length ``mel2ph`` -> UMLN (identity at inference) -> residual style
adaptor (WN + ConvBlocks + RQ + prosody aligner) -> pitch -> decoder.

- pitch (``f0_gen``): ``gmdiff``, the dual joint f0 + uv diffusion with the
  MIDI +-3 semitone clip (ancestral, or strided with ``f0_speedup`` > 1),
  or ``conv``, the two conv pitch predictors;
- decoder: ``diffsinger``, the FFT decoder and a shallow mel diffusion
  (ancestral, PLMS with ``pndm_speedup`` > 1, or DPM-Solver++(2M) with
  ``dpm_steps`` > 0, which takes precedence) on the WaveNet or the FFT
  denoiser (``diff_decoder_type``); ``fft``, the FFT decoder alone; or
  ``prodiff``, x0-parameterized diffusion from noise in place of the FFT
  decoder.

``forward(infer=True)`` is zero-shot inference (under ``no_grad``);
``forward(infer=False)`` is the training pass of ``StyleSinger.__call__``
with the curriculum flags ``use_rq``, ``forcing`` and ``use_diff`` and the
ground-truth ``mel2ph``, f0 and uv, returning the training outputs and the
model-side losses (``diff_loss``, ``gdiff*``/``mdiff*``, ``gloss``,
``rq_loss``).  Its randomness comes from one noise source per JAX stream
(``dropout``, ``umln``, ``rq``, ``diffusion``); ``deterministic=True``
(validation) turns dropout, UMLN and the codebook update off.  ProDiff
trains by predicting the ground-truth mel from its diffused copy at a drawn
t (its mel losses are the caller's).

``use_spk_id`` swaps the d-vector projection for an ``Embedding(num_spk +
1)`` of integer speaker ids, passed as ``spk_embed``; ``rel_pos`` gives the
phone encoder ESPnet's relative positions; a ``pitch_type`` other than
``frame`` turns uv off.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.dsp.pitch import denorm_f0, f0_to_coarse
from stylesinger_torch.models import diffusion as diff
from stylesinger_torch.models.common import (
    Dense, DurationPredictor, Embedding, FastspeechDecoder, FastspeechEncoder,
    PitchPredictor, SinusoidalPositionalEmbedding,
)
from stylesinger_torch.models.diffnet import (
    DDiffNet, DiffNet, FFTDenoiser, cond_cache,
)
from stylesinger_torch.models.fs2 import (
    DVEC_DIM, expand_states, grad_scale, predict_mel2ph,
)
from stylesinger_torch.models.style import LocalStyleAdaptor, ProsodyAligner
from stylesinger_torch.models.umln import UMLN
from stylesinger_torch.utils import profiling

_LF0_MIN = 6.0
_LF0_MAX = 10.0


def minmax_norm_lf0(x: torch.Tensor,
                    uv: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = torch.clamp_max(x, _LF0_MAX)
    normed = (x - _LF0_MIN) / (_LF0_MAX - _LF0_MIN) * 2 - 1
    if uv is not None:
        normed = torch.where(uv > 0, torch.zeros_like(normed), normed)
    return normed


def minmax_denorm_lf0(x: torch.Tensor,
                      uv: Optional[torch.Tensor] = None) -> torch.Tensor:
    denormed = (x + 1) / 2 * (_LF0_MAX - _LF0_MIN) + _LF0_MIN
    if uv is not None:
        denormed = torch.where(uv > 0, torch.zeros_like(denormed), denormed)
    return denormed


class NoteEncoder(nn.Module):
    """MIDI pitch emb + type emb (both * sqrt(H)) + linear duration."""

    def __init__(self, hidden: int, n_vocab: int = 100, n_types: int = 5):
        super().__init__()
        self.scale = math.sqrt(hidden)
        self.emb = Embedding(n_vocab, hidden)
        self.type_emb = Embedding(n_types, hidden)
        self.dur_ln = Dense(1, hidden)

    def forward(self, note, note_dur, note_type):
        return (self.emb(note) * self.scale +
                self.type_emb(note_type) * self.scale +
                self.dur_ln(note_dur[..., None]))


def _check_supported(c: Any) -> None:
    unsupported = {
        "f0_gen": c["f0_gen"] not in ("gmdiff", "conv"),
        "decoder": c["decoder"] not in ("diffsinger", "fft", "prodiff"),
        "diff_decoder_type": c.get("diff_decoder_type", "wavenet")
        not in ("wavenet", "fft"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"stylesinger_torch does not port these settings yet: {bad}")


class StyleSinger(nn.Module):
    def __init__(self, cfg: Any, vocab_size: int):
        super().__init__()
        _check_supported(cfg)
        c = self.cfg = cfg
        h = c["hidden_size"]
        m = c["audio_num_mel_bins"]
        self.encoder = FastspeechEncoder(vocab_size, h, c["enc_layers"],
                                         c["enc_ffn_kernel_size"],
                                         num_heads=c["num_heads"],
                                         dropout=c["dropout"],
                                         rel_pos=bool(c.get("rel_pos",
                                                            False)))
        self.note_encoder = NoteEncoder(h, c["note_vocab"],
                                        c["note_type_vocab"])
        self.use_spk_id = bool(c.get("use_spk_id", False))
        if self.use_spk_id:
            self.spk_embed_proj = Embedding(c["num_spk"] + 1, h)
        else:
            self.spk_embed_proj = Dense(DVEC_DIM, h)
        if c["emo"]:
            self.emo_embed_proj = Dense(DVEC_DIM, h)
        if c["umln"]:
            self.norm = UMLN(h)
        if c["style"]:
            self.style_extractor = LocalStyleAdaptor(
                h, n_codes=c["nRQ"], rq_depth=c["rq_depth"], mel_bins=m,
                wn_layers=c.get("style_wn_layers", 4),
                conv_dilations=tuple(c.get("style_conv_dilations",
                                           (1, 1, 1, 1, 1))),
                rq_decay=c["rq_decay"], vae_dropout=c["vae_dropout"])
            self.style_pos = SinusoidalPositionalEmbedding(h)
            self.l1 = Dense(2 * h, h)
            self.align = ProsodyAligner(
                h, num_layers=c["aligner_layers"], num_heads=c["num_heads"],
                ffn_dim=c["aligner_ffn_dim"], guided_sigma=c["guided_sigma"])
        ph = c["predictor_hidden"] if c["predictor_hidden"] > 0 else h
        self.dur_predictor = DurationPredictor(
            h, ph, n_layers=c["dur_predictor_layers"],
            kernel_size=c["dur_predictor_kernel"],
            dropout=c["predictor_dropout"])
        self.pitch_embed = Embedding(300, h, padding_idx=0)
        if c["f0_gen"] == "gmdiff":
            for name in ("gm_diffnet", "gm_diffnet_inpainte"):
                setattr(self, name, DDiffNet(
                    in_dims=1, num_classes=2, cond_dim=h,
                    residual_layers=c["f0_residual_layers"],
                    residual_channels=c["f0_residual_channels"],
                    dilation_cycle_length=c["f0_dilation_cycle_length"]))
            self.f0_sched = diff.make_schedule(c["f0_timesteps"],
                                               c["f0_max_beta"], "linear")
        else:
            for name in ("pitch_predictor", "pitch_inpainter_predictor"):
                setattr(self, name, PitchPredictor(
                    h, ph, odim=2, n_layers=5,
                    kernel_size=c["predictor_kernel"]))
        if c["decoder"] != "prodiff":  # ProDiff replaces the FFT decoder
            self.decoder = FastspeechDecoder(h, c["dec_layers"],
                                             c["dec_ffn_kernel_size"],
                                             num_heads=c["num_heads"],
                                             dropout=c["dropout"])
            self.mel_out = Dense(h, m)
        if c["decoder"] in ("diffsinger", "prodiff"):
            if c.get("diff_decoder_type", "wavenet") == "fft":
                self.postdiff = FFTDenoiser(
                    in_dims=m, hidden_size=h,
                    residual_channels=c["residual_channels"],
                    num_layers=c["dec_layers"],
                    kernel_size=c["dec_ffn_kernel_size"],
                    num_heads=c["num_heads"])
            else:
                self.postdiff = DiffNet(
                    in_dims=m, cond_dim=h,
                    residual_layers=c["residual_layers"],
                    residual_channels=c["residual_channels"],
                    dilation_cycle_length=c["dilation_cycle_length"])
        if c["decoder"] == "diffsinger":
            self.mel_sched = diff.make_schedule(
                c["timesteps"], c["max_beta"], c["schedule_type"])
            n_cond = (m + (h if c["use_txt_cond"] else 0) + h +
                      (h if c["emo"] else 0) + (h if c["style"] else 0))
            self.ln_proj = Dense(n_cond, h)
        elif c["decoder"] == "prodiff":
            self.mel_sched = diff.make_prodiff_schedule(
                c["timesteps"], c.get("prodiff_schedule", "vpsde"))
        kb = c["keep_bins"]
        for name in ("spec_min", "spec_max"):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(c[name], np.float32)[:kb]), persistent=False)

    # ------------------------------------------------------------- style
    def get_style(self, decoder_inp, ref_mels, ref_f0, tgt_nonpadding,
                  ret: Dict, use_rq: bool = True, forcing: bool = False,
                  rq_noise=None, drop=None):
        """Style extraction and content-style alignment; the RQ commitment
        and guided-attention losses go to ``ret``."""
        style, rq_loss, _codes = self.style_extractor(
            ref_mels, ref_f0, use_rq=use_rq, noise=rq_noise, drop=drop)
        ref_nonpadding = (ref_mels[:, :, 0].abs() > 1e-8).to(torch.float32)
        style = self.l1(torch.cat([style, self.style_pos(ref_nonpadding)],
                                  dim=-1))
        aligned, gloss, _attn = self.align(decoder_inp, style,
                                           tgt_nonpadding, ref_nonpadding,
                                           forcing=forcing, drop=drop)
        ret["gloss"] = gloss
        if rq_loss is not None:
            ret["rq_loss"] = rq_loss
        return aligned

    # ------------------------------------------------------------- pitch
    def inpaint_pitch(self, inp_agnostic, inp_specific, f0, uv, mel2ph,
                      note, noise, drop, ret: Dict, *, infer: bool):
        """The two pitch paths (agnostic, specific), averaged.  Inference
        samples the f0 + uv diffusions; training takes their losses
        (``gdiff1``/``mdiff1`` agnostic, ``gdiff2``/``mdiff2`` specific)
        and reads the pitch embedding off the ground-truth ``f0``/``uv``."""
        c = self.cfg
        nonpadding = (mel2ph > 0).to(torch.float32)
        inp_agnostic = grad_scale(inp_agnostic, c["predictor_grad"])
        inp_specific = grad_scale(inp_specific, c["predictor_grad"])
        if c["f0_gen"] == "gmdiff" and infer:
            midi_notes = expand_states(note.to(torch.float32)[:, :, None],
                                       mel2ph)[..., 0]
            p_agn, p_spec = self._gmdiff_pitch(
                inp_agnostic, inp_specific, nonpadding, midi_notes, noise)
        elif c["f0_gen"] == "gmdiff":
            normed = minmax_norm_lf0(f0)[..., None]
            for k, net, cond in (("1", self.gm_diffnet, inp_agnostic),
                                 ("2", self.gm_diffnet_inpainte,
                                  inp_specific)):
                ret[f"mdiff{k}"], ret[f"gdiff{k}"] = diff.gm_mixed_loss(
                    lambda f0_t, uv_t, t, net=net, cond=cond:
                    net(f0_t, uv_t, t, cond, nonpadding),
                    self.f0_sched, normed, uv, nonpadding, noise)
            p_agn = p_spec = torch.stack([f0, uv], dim=-1)
        else:
            p_agn = self.pitch_predictor(inp_agnostic, nonpadding, drop)
            p_spec = self.pitch_inpainter_predictor(inp_specific, nonpadding,
                                                    drop)
        pitch_pred = p_spec / 2 + p_agn / 2
        ret["pitch_pred"] = pitch_pred
        use_uv = c["pitch_type"] == "frame" and c["use_uv"]
        if infer:
            f0 = pitch_pred[:, :, 0]
            uv = (pitch_pred[:, :, 1] > 0).to(torch.float32)
        f0_denorm = denorm_f0(f0, uv if use_uv else None,
                              pitch_norm=c["pitch_norm"],
                              f0_mean=c["f0_mean"], f0_std=c["f0_std"],
                              pitch_padding=mel2ph == 0)
        ret["f0_denorm"] = f0_denorm
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def _gmdiff_pitch(self, inp_agnostic, inp_specific, nonpadding,
                      midi_notes, noise):
        """Dual joint f0 + uv diffusion (strided with ``f0_speedup`` > 1);
        rests forced unvoiced.  Returns the two [B, T, 2] predictions."""
        lo = (midi_notes - 3.0 - 69.0) / 12.0 + math.log2(440.0)
        hi = (midi_notes + 3.0 - 69.0) / 12.0 + math.log2(440.0)
        lo = torch.clamp(minmax_norm_lf0(lo), -1.0, 1.0)[..., None]
        hi = torch.clamp(minmax_norm_lf0(hi), -1.0, 1.0)[..., None]

        def fn_a(f0_t, uv_t, t):
            profiling.count("denoiser.f0")
            return self.gm_diffnet(f0_t, uv_t, t, inp_agnostic, nonpadding)

        def fn_b(f0_t, uv_t, t):
            profiling.count("denoiser.f0")
            return self.gm_diffnet_inpainte(f0_t, uv_t, t, inp_specific,
                                            nonpadding)

        with profiling.span("acoustic.f0_diffusion"), cond_cache():
            (fa, ua), (fb, ub) = diff.sample_gm_dual(
                fn_a, fn_b, self.f0_sched, inp_agnostic.shape[1],
                inp_agnostic.shape[0], noise, dyn_clip=(lo, hi),
                speedup=int(self.cfg.get("f0_speedup", 1)))
        rest = (midi_notes == 0)[..., None]
        preds = []
        for f, u in ((fa, ua), (fb, ub)):
            p = torch.stack([minmax_denorm_lf0(f[..., 0]), u], dim=-1)
            forced = torch.cat([p[..., :1], torch.ones_like(p[..., 1:])],
                               dim=-1)
            preds.append(torch.where(rest, forced, p))
        return preds

    # ----------------------------------------------------------- forward
    def forward(self, txt_tokens: torch.Tensor, spk_embed: torch.Tensor,
                emo_embed: torch.Tensor, ref_mels: torch.Tensor,
                ref_f0: torch.Tensor, note: torch.Tensor,
                note_dur: torch.Tensor, note_type: torch.Tensor, noise,
                max_frames: Optional[int] = None, *, infer: bool = True,
                mel2ph: Optional[torch.Tensor] = None,
                f0: Optional[torch.Tensor] = None,
                uv: Optional[torch.Tensor] = None, use_rq: bool = True,
                forcing: bool = False, use_diff: bool = True,
                deterministic: bool = False) -> Dict:
        """``infer=True``: zero-shot inference (under ``no_grad``) from the
        noise source ``noise``; returns mel_out [B, max_frames, M],
        f0_denorm [B, max_frames], mel2ph, dur and pitch_pred.

        ``infer=False``: the training pass on the ground-truth ``mel2ph``
        [B, T], ``f0`` (log2 Hz, interpolated) and ``uv`` [B, T];
        ``ref_mels``/``ref_f0`` are the item's own mel and f0.  ``noise``
        maps each stream to its source: ``dropout`` (None turns dropout
        off), ``umln``, ``rq`` and ``diffusion``; with ``deterministic``
        only ``diffusion`` is read.  Returns, besides, style, decoder_inp
        and the model-side losses of the phase."""
        grad = torch.is_grad_enabled() and not infer
        # switch only a mode that changes (a traced switch costs torch.export
        # a pass over the whole graph)
        with contextlib.nullcontext() if grad == torch.is_grad_enabled() \
                else torch.set_grad_enabled(grad):
            return self._forward(
                txt_tokens, spk_embed, emo_embed, ref_mels, ref_f0, note,
                note_dur, note_type, {"diffusion": noise} if infer else noise,
                max_frames, infer=infer, mel2ph=mel2ph, f0=f0, uv=uv,
                use_rq=use_rq or infer, forcing=forcing and not infer,
                use_diff=use_diff, deterministic=deterministic or infer)

    def _forward(self, txt_tokens, spk_embed, emo_embed, ref_mels, ref_f0,
                 note, note_dur, note_type, noise: Dict, max_frames, *,
                 infer, mel2ph, f0, uv, use_rq, forcing, use_diff,
                 deterministic) -> Dict:
        c = self.cfg
        drop = None if deterministic else noise.get("dropout")
        ret: Dict = {}
        encoder_out = self.encoder(txt_tokens, drop) + self.note_encoder(
            note, note_dur, note_type)
        src_nonpadding = (txt_tokens > 0).to(torch.float32)
        if self.use_spk_id and spk_embed.dim() != 1:
            raise ValueError("use_spk_id: spk_embed must be the speaker ids "
                             f"[B], not {tuple(spk_embed.shape)}")
        spk = self.spk_embed_proj(spk_embed.long() if self.use_spk_id
                                  else spk_embed)[:, None, :]
        emo = self.emo_embed_proj(emo_embed)[:, None, :] if c["emo"] else 0.0

        dur_inp = grad_scale((encoder_out + spk + emo) *
                             src_nonpadding[..., None], c["predictor_grad"])
        ret["dur"] = self.dur_predictor(dur_inp, src_nonpadding, drop)
        if infer:
            mel2ph = predict_mel2ph(ret["dur"], src_nonpadding,
                                    max_frames or c["max_frames"])
        ret["mel2ph"] = mel2ph
        tgt = (mel2ph > 0).to(torch.float32)
        tgt3 = tgt[..., None]
        decoder_inp = expand_states(encoder_out, mel2ph)
        if c["umln"]:
            decoder_inp = self.norm(decoder_inp, spk + emo,
                                    None if deterministic else noise["umln"])

        style = 0.0
        if c["style"]:
            style = self.get_style(
                decoder_inp, ref_mels, ref_f0, tgt, ret, use_rq=use_rq,
                forcing=forcing,
                rq_noise=None if deterministic else noise["rq"], drop=drop)
        ret["style"] = style
        pitch_embed = self.inpaint_pitch(
            decoder_inp * tgt3, (decoder_inp + spk + emo + style) * tgt3,
            f0, uv, mel2ph, note, noise["diffusion"], drop, ret, infer=infer)

        decoder_inp = decoder_inp + spk + emo + pitch_embed
        if c["style"]:
            decoder_inp = decoder_inp + style
        decoder_inp = decoder_inp * tgt3
        ret["decoder_inp"] = decoder_inp
        if c["decoder"] == "prodiff":
            ret["mel_out"] = self.run_prodiff(
                decoder_inp, noise["diffusion"],
                ref_mels=None if infer else ref_mels, drop=drop) * tgt3
            return ret
        coarse = self.mel_out(self.decoder(decoder_inp, tgt, drop)) * tgt3
        ret["mel_out"] = coarse
        if c["decoder"] == "diffsinger" and use_diff:
            b, t = coarse.shape[:2]
            feats = [coarse.detach()] + (
                [decoder_inp] if c["use_txt_cond"] else [])
            feats.append(spk.expand(b, t, -1))
            if c["emo"]:
                feats.append(emo.expand(b, t, -1))
            if c["style"]:
                feats.append(style)
            cond = self.ln_proj(torch.cat(feats, dim=-1))
            if infer:
                ret["mel_out"] = self.run_diffsinger(
                    coarse, cond, noise["diffusion"]) * tgt3
            else:
                ret["diff_loss"] = diff.shallow_p_losses(
                    self._denoiser(cond, drop), self.mel_sched,
                    diff.norm_spec(ref_mels, self.spec_min, self.spec_max),
                    noise["diffusion"], c["K_step"], nonpadding=tgt)
        return ret

    def _denoiser(self, cond, drop=None):
        """The mel denoiser on ``cond`` as ``fn(x_t, t)``; the FFT denoiser
        carries dropout."""
        args = (cond, drop) if isinstance(self.postdiff, FFTDenoiser) \
            else (cond,)

        def fn(x_t, t_):
            profiling.count("denoiser.mel")
            return self.postdiff(x_t, t_, *args)
        return fn

    def run_diffsinger(self, coarse, cond, noise):
        """Shallow mel diffusion from the coarse mel: DPM-Solver++(2M) when
        ``dpm_steps`` > 0, else PLMS when ``pndm_speedup`` > 1, else the
        ancestral chain."""
        c = self.cfg
        denoise_fn = self._denoiser(cond)
        coarse_norm = diff.norm_spec(coarse, self.spec_min, self.spec_max)
        speedup = int(c.get("pndm_speedup", 1) or 1)
        dpm_steps = int(c.get("dpm_steps", 0) or 0)
        with profiling.span("acoustic.mel_diffusion"), cond_cache():
            if dpm_steps > 0:
                x = diff.sample_shallow_dpmpp(denoise_fn, self.mel_sched,
                                              coarse_norm, noise,
                                              c["K_step"], dpm_steps)
            elif speedup > 1:
                x = diff.sample_shallow_plms(denoise_fn, self.mel_sched,
                                             coarse_norm, noise, c["K_step"],
                                             speedup)
            else:
                x = diff.sample_shallow(denoise_fn, self.mel_sched,
                                        coarse_norm, noise, c["K_step"])
        return diff.denorm_spec(x, self.spec_min, self.spec_max)

    def run_prodiff(self, decoder_inp, noise, ref_mels=None, drop=None):
        """ProDiff in place of the FFT decoder, conditioned on
        ``decoder_inp``: x0-parameterized diffusion from noise, or, given
        the ground-truth ``ref_mels`` (training), the x0 predicted from
        them diffused to a drawn t."""
        c = self.cfg
        if isinstance(self.postdiff, FFTDenoiser):
            def denoise_fn(x_t, t_):
                return self.postdiff(x_t, t_, decoder_inp, drop)
        else:
            def denoise_fn(x_t, t_):
                return self.postdiff(x_t, t_, decoder_inp)
        if ref_mels is not None:
            return diff.prodiff_train(denoise_fn, self.mel_sched,
                                      c["timesteps"], ref_mels, noise)
        shape = (decoder_inp.shape[0], decoder_inp.shape[1],
                 c["audio_num_mel_bins"])
        return diff.sample_prodiff(denoise_fn, self.mel_sched,
                                   c["timesteps"], shape, noise)
