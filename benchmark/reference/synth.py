"""Batch synthesis worked out again, stage by stage, by the plain
reference (``plain/``) from the same requests, weights and draws.

A diffusion sampler is chaotic in its discrete draws: an F0 chain's
voicing is a Gumbel argmax at each of its 100 steps over every frame, and
one near-tie that rounds the other way sends the rest of the chain
elsewhere.  So the reference does not run the sampler end to end beside
the program; it follows the program step by step from the program's own
state, and checks each stage by itself:

1. front-end: each request's ids (exact), and its log-mel, F0 and both
   d-vectors worked out again from its recording (``fe``, the worst of
   the four); the batch's padding into buckets (exact);
2. the acoustic model up to the F0 chains, on the program's padded batch:
   the duration head's output; ``mel2ph`` from the program's durations
   (exact); the style before RQ; each RQ code, by the gap by which the
   program's code lies behind the reference's nearest one; both chains'
   conditions, on the program's ``mel2ph`` and codes;
3. at the checked steps of each F0 chain (the first, the last and some
   drawn from the seed): the denoiser on the program's input
   (``f0_net``); the step (``f0_step``): the Gaussian step to the
   program's next input, each voicing choice by the gap by which it lies
   behind the reference's best, and at the last step the pitch
   prediction both chains give;
4. from the program's pitch: the F0 in Hz and the mel condition through
   the decoder (``mel_cond``);
5. at the checked steps of the mel chain: the denoiser (``mel_net``) and
   the step to the program's next input, at the last step to the mel the
   program returned (``mel_step``);
6. the vocoder on the program's mel and F0 with the same draws: the wav.

Each number is the worst over the batch.  ``rel`` is max |got - want| /
max |want| over a whole tensor.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.harness.checks import Checks
from benchmark.reference.plain import diffusion as diff
from benchmark.reference.plain.fs2 import expand_states, predict_mel2ph
from benchmark.reference.plain.infer import PlainInfer
from benchmark.reference.plain.pitch import denorm_f0, f0_to_coarse
from benchmark.reference.plain.stylesinger import minmax_denorm_lf0, \
    minmax_norm_lf0
from benchmark.reference.vocode import wav_errors

INF = float("inf")


class Given:
    """A noise source that hands out the given draws in order."""

    def __init__(self, draws: List[torch.Tensor]):
        self.draws = list(draws)

    def _take(self, shape) -> torch.Tensor:
        x = self.draws.pop(0)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"draw {tuple(x.shape)} for {tuple(shape)}")
        return x

    def normal(self, shape):
        return self._take(shape)

    def uniform(self, shape):
        return self._take(shape)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(want.shape):
        return INF
    d = (got.double() - want.double()).abs().max()
    return float(d / want.double().abs().max().clamp_min(1e-12))


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel(), 1)
    return int((got != want).sum())


def check_batch(cfg, phones, states, dev, limits, steps, pool,
                items) -> Checks:
    checks = Checks(limits)
    if not items:
        checks.fail("no batch finished in the window")
        return checks
    pool_idx, rec, outs = items[0]
    ref = PlainInfer(cfg, phones, dev)
    ref.load(states)
    with torch.no_grad():
        frontend(checks, ref, pool[pool_idx], rec)
        pre = acoustic_pre(checks, ref.model, rec, cfg)
        f0_chains(checks, ref.model, rec, pre, sorted(steps["f0"]))
        acoustic_post(checks, ref.model, rec, pre, cfg)
        mel_chain(checks, ref.model, rec, pre, sorted(steps["mel"]))
        vocoder(checks, ref.vocoder, rec, pre, outs)
    return checks


def frontend(checks: Checks, ref: PlainInfer, batch, rec) -> None:
    ids = 0
    if len(rec["fe"]) != len(batch):
        checks.fail(f"{len(rec['fe'])} front-end outputs for "
                    f"{len(batch)} requests")
        return
    for inp, got in zip(batch, rec["fe"]):
        want = ref.preprocess_input(inp)
        for k in ("txt_tokens", "note", "note_type", "note_dur"):
            ids += mismatches(got[k], want[k])
        checks.add("fe", max(rel(got[k], want[k]) for k in (
            "ref_mels", "ref_f0", "spk_embed", "emo_embed")))
    checks.add("fe_ids", ids)
    joint = ref.join(rec["fe"])
    checks.add("join", sum(mismatches(rec["joint"][k], v)
                           for k, v in joint.items()))


def acoustic_pre(checks: Checks, m, rec, cfg) -> Dict[str, Any]:
    j, r = rec["joint"], rec["ret"]
    txt = j["txt_tokens"]
    enc = m.encoder(txt, None) + m.note_encoder(j["note"], j["note_dur"],
                                                j["note_type"])
    src = (txt > 0).to(torch.float32)
    spk = m.spk_embed_proj(j["spk_embed"])[:, None, :]
    emo = m.emo_embed_proj(j["emo_embed"])[:, None, :]
    dur = m.dur_predictor((enc + spk + emo) * src[..., None], src, None)
    checks.add("dur", rel(r["dur"], dur))
    checks.add("mel2ph", mismatches(
        r["mel2ph"], predict_mel2ph(r["dur"], src, cfg["max_frames"])))
    mel2ph = r["mel2ph"]
    tgt = (mel2ph > 0).to(torch.float32)
    dec = expand_states(enc, mel2ph)        # UMLN: the identity at inference

    se = m.style_extractor
    ref_mels = j["ref_mels"]
    np_ref = (ref_mels[:, :, 0].abs() > 1e-8).to(ref_mels.dtype)
    x = se.encoder(se.wavenet(ref_mels, np_ref) + j["ref_f0"][..., None],
                   np_ref, None)
    checks.add("rq_in", rel(rec["rq_in"], x))
    checks.add("rq_gap", 0.0)
    codes = rec["rq_codes"]
    residual, agg = x, torch.zeros_like(x)
    for i in range(se.rq.rq_depth):
        cb = getattr(se.rq, f"codebook_{i}").embedding
        flat = residual.reshape(-1, residual.shape[-1])
        dist = (flat ** 2).sum(-1, keepdim=True) + (cb ** 2).sum(-1)[None] \
            - 2.0 * flat @ cb.T
        chosen = codes[..., i].reshape(-1)
        gap = dist.gather(1, chosen[:, None])[:, 0] - dist.min(1).values
        scale = (flat ** 2).sum(-1) + (cb[chosen] ** 2).sum(-1)
        checks.add("rq_gap", float((gap / scale.clamp_min(1e-12)).max()))
        quant = cb[chosen].reshape(residual.shape)
        residual = residual - quant
        agg = agg + quant
    style = m.l1(torch.cat([x + (agg - x), m.style_pos(np_ref)], dim=-1))
    style, _, _ = m.align(dec, style, tgt, np_ref, forcing=False, drop=None)
    tgt3 = tgt[..., None]
    checks.add("cond_f0", max(
        rel(rec["f0_cond_a"][0], dec * tgt3),
        rel(rec["f0_cond_b"][0], (dec + spk + emo + style) * tgt3)))
    midi = expand_states(j["note"].to(torch.float32)[:, :, None],
                         mel2ph)[..., 0]
    return dict(spk=spk, emo=emo, dec=dec, tgt=tgt, tgt3=tgt3, style=style,
                mel2ph=mel2ph, midi=midi)


def _gap(score: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """Per frame: how far the chosen class's score lies behind the best
    (score [B, K, T], choice [B, T]), as a share of the best score's
    magnitude (at least 1), so that a rounding near-tie reads as small as
    rounding does in the other relative numbers."""
    best = score.max(1).values
    gap = best - score.gather(1, choice[:, None])[:, 0]
    return gap / best.abs().clamp_min(1.0)


def f0_chains(checks: Checks, m, rec, pre, steps) -> None:
    sched = m.f0_sched
    midi = pre["midi"]
    lo = (midi - 3.0 - 69.0) / 12.0 + math.log2(440.0)
    hi = (midi + 3.0 - 69.0) / 12.0 + math.log2(440.0)
    clip = (torch.clamp(minmax_norm_lf0(lo), -1.0, 1.0)[..., None],
            torch.clamp(minmax_norm_lf0(hi), -1.0, 1.0)[..., None])
    finals = {}
    for chain, net in (("a", m.gm_diffnet), ("b", m.gm_diffnet_inpainte)):
        cond, nonpad = rec[f"f0_cond_{chain}"]
        calls = rec["f0"][chain]
        for s in steps:
            call = calls.get(s)
            if call is None or (s > 0 and calls.get(s - 1) is None):
                checks.fail(f"F0 chain {chain}, step {s}: not recorded")
                continue
            b = call["x"].shape[0]
            t = torch.full((b,), s, dtype=torch.long, device=call["x"].device)
            out = net(call["x"], call["uv"], t, cond, nonpad)
            checks.add("f0_net", rel(call["out"], out))
            z_draw = rec["draws"][call["draw0"]]
            u_draw = rec["draws"][call["draw0"] + 1]
            z = diff.gaussian_p_sample(sched, call["x"], t, out[..., :1],
                                       Given([z_draw]), clip=clip)
            log_model = diff.cat_p_pred(
                sched, out[..., 1:].transpose(1, 2),
                diff.index_to_log_onehot(call["uv"], 2), t, 2)
            score = log_model - torch.log(-torch.log(u_draw + 1e-30) + 1e-30)
            if s > 0:
                nxt = calls[s - 1]
                checks.add("f0_step", max(rel(nxt["x"], z), float(
                    _gap(score, nxt["uv"]).max())))
            else:
                finals[chain] = (z, score)
    if len(finals) == 2:
        last_step(checks, rec, pre, finals)


def last_step(checks: Checks, rec, pre, finals) -> None:
    """The last step of both chains, as the pitch prediction it gives:
    its F0 against the program's, and its voicing by the least gap of a
    pair of choices that gives the program's mean (rests are forced
    unvoiced); read into ``f0_step``."""
    (za, sa), (zb, sb) = finals["a"], finals["b"]
    prog = rec["ret"]["pitch_pred"]
    f0 = minmax_denorm_lf0(zb[..., 0]) / 2 + minmax_denorm_lf0(za[..., 0]) / 2
    pitch_err = rel(prog[..., 0], f0)
    zero = torch.zeros_like(prog[..., 1], dtype=torch.long)
    one = torch.ones_like(zero)
    ga0, ga1, gb0, gb1 = (_gap(sa, zero), _gap(sa, one), _gap(sb, zero),
                          _gap(sb, one))
    u = prog[..., 1]
    gap = torch.where(u == 0, ga0 + gb0, torch.where(
        u == 1, ga1 + gb1, torch.where(
            u == 0.5, torch.minimum(ga0 + gb1, ga1 + gb0),
            torch.full_like(u, INF))))
    rest = pre["midi"] == 0
    gap = torch.where(rest, torch.where(u == 1, torch.zeros_like(u),
                                        torch.full_like(u, INF)), gap)
    checks.add("f0_step", max(pitch_err, float(gap.max())))


def acoustic_post(checks: Checks, m, rec, pre, cfg) -> None:
    r = rec["ret"]
    pp = r["pitch_pred"]
    uv = (pp[..., 1] > 0).to(torch.float32)
    use_uv = cfg["pitch_type"] == "frame" and cfg["use_uv"]
    f0_denorm = denorm_f0(pp[..., 0], uv if use_uv else None,
                          pitch_norm=cfg["pitch_norm"],
                          f0_mean=cfg["f0_mean"], f0_std=cfg["f0_std"],
                          pitch_padding=pre["mel2ph"] == 0)
    f0_err = rel(r["f0_denorm"], f0_denorm)
    tgt3 = pre["tgt3"]
    dec = pre["dec"] + pre["spk"] + pre["emo"] + m.pitch_embed(
        f0_to_coarse(r["f0_denorm"]))
    dec = (dec + pre["style"]) * tgt3
    coarse = m.mel_out(m.decoder(dec, pre["tgt"], None)) * tgt3
    b, t = coarse.shape[:2]
    feats = [coarse] + ([dec] if cfg["use_txt_cond"] else []) + [
        pre["spk"].expand(b, t, -1)]
    if cfg["emo"]:
        feats.append(pre["emo"].expand(b, t, -1))
    if cfg["style"]:
        feats.append(pre["style"])
    checks.add("mel_cond", max(f0_err, rel(
        rec["mel_cond"], m.ln_proj(torch.cat(feats, dim=-1)))))


def mel_chain(checks: Checks, m, rec, pre, steps) -> None:
    sched = m.mel_sched
    calls = rec["mel"]
    for s in steps:
        call = calls.get(s)
        if call is None or (s > 0 and calls.get(s - 1) is None):
            checks.fail(f"mel chain, step {s}: not recorded")
            continue
        b = call["x"].shape[0]
        t = torch.full((b,), s, dtype=torch.long, device=call["x"].device)
        out = m.postdiff(call["x"], t, rec["mel_cond"])
        checks.add("mel_net", rel(call["out"], out))
        x = diff.gaussian_p_sample(sched, call["x"], t, out,
                                   Given([rec["draws"][call["draw0"]]]),
                                   clip=(-1.0, 1.0))
        if s > 0:
            checks.add("mel_step", rel(calls[s - 1]["x"], x))
        else:
            mel = diff.denorm_spec(x, m.spec_min, m.spec_max) * pre["tgt3"]
            checks.add("mel_step", rel(rec["ret"]["mel_out"], mel))


def vocoder(checks: Checks, voc, rec, pre, outs) -> None:
    r = rec["ret"]
    n_frames = (pre["mel2ph"] > 0).sum(-1).tolist()
    crop, call = 0, 0
    for b, t in enumerate(n_frames):
        o = outs[b]
        crop += mismatches(torch.as_tensor(o["mel"]),
                           r["mel_out"][b, :t].cpu())
        crop += mismatches(torch.as_tensor(o["f0"]),
                           r["f0_denorm"][b, :t].cpu())
        if t == 0:
            continue
        i0 = rec["voc"][call]
        call += 1
        wav = voc(r["mel_out"][b: b + 1, :t], r["f0_denorm"][b: b + 1, :t],
                  Given([rec["draws"][i0], rec["draws"][i0 + 1]]))[0]
        for name, v in wav_errors(o["wav"], wav.cpu().numpy()).items():
            checks.add(name, v)
    checks.add("crop", crop)
