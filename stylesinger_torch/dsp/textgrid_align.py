"""MFA TextGrid alignment -> mel2ph (the generic-TTS binarizer path; port
of ``stylesinger_tpu/dsp/textgrid_align.py``, host numpy).

Parity target: ``get_mel2ph`` (``utils/audios/align.py:10-50`` in
AaronZ345/StyleSinger): parse the phones tier of an MFA TextGrid, merge
sub-threshold silences into the previous interval, walk intervals and
phoneme list in lockstep (silence-tolerant), and emit the per-frame phoneme
index map + durations.  Includes a dependency-free TextGrid parser
(replaces the ``textgrid`` package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from stylesinger_torch.dsp.align import mel2ph_to_dur


@dataclass
class Interval:
    min_time: float
    max_time: float
    mark: str


def is_sil_phoneme(p: str) -> bool:
    """Silence-ish marks: empty, punctuation-ish, or <...> specials
    (reference utils/text/text_encoder.py ``is_sil_phoneme``)."""
    return not p or not p[0].isalnum()


def parse_textgrid(path_or_text: str) -> List[List[Interval]]:
    """Minimal long-format TextGrid parser -> list of tiers of intervals."""
    if "\n" in path_or_text or "xmin" in path_or_text[:200]:
        text = path_or_text
    else:
        with open(path_or_text, encoding="utf-8",
                  errors="replace") as f:
            text = f.read()
    tiers: List[List[Interval]] = []
    for tier_block in re.split(r"item\s*\[\d+\]\s*:", text)[1:]:
        intervals = []
        for m in re.finditer(
                r"intervals\s*\[\d+\]\s*:?\s*"
                r"xmin\s*=\s*([\d.eE+-]+)\s*"
                r"xmax\s*=\s*([\d.eE+-]+)\s*"
                r'text\s*=\s*"([^"]*)"', tier_block):
            intervals.append(Interval(float(m.group(1)), float(m.group(2)),
                                      m.group(3).strip()))
        tiers.append(intervals)
    return tiers


def get_mel2ph_from_textgrid(tg: str, ph: str, n_frames: int,
                             hop_size: int, sample_rate: int,
                             min_sil_duration: float = 0.0,
                             tier: int = 1
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(mel2ph [n_frames], dur [n_ph]); mirrors the reference walk."""
    ph_list = ph.split(" ")
    itvs = parse_textgrid(tg)[tier]
    merged: List[Interval] = []
    for i, itv in enumerate(itvs):
        if (itv.max_time - itv.min_time) < min_sil_duration and i > 0 and \
                is_sil_phoneme(itv.mark):
            merged[-1].max_time = itv.max_time
        else:
            merged.append(itv)
    tg_len = len([x for x in merged if not is_sil_phoneme(x.mark)])
    ph_len = len([x for x in ph_list if not is_sil_phoneme(x)])
    if tg_len != ph_len:
        raise ValueError(f"the TextGrid has {tg_len} non-silent intervals, "
                         f"the phones {ph_len}: {ph_list}")

    mel2ph = np.zeros([n_frames], np.int64)
    i_itv = i_ph = 0
    while i_itv < len(merged):
        itv = merged[i_itv]
        cur_ph = ph_list[i_ph] if i_ph < len(ph_list) else ""
        s = int(itv.min_time * sample_rate / hop_size + 0.5)
        e = int(itv.max_time * sample_rate / hop_size + 0.5)
        if is_sil_phoneme(itv.mark) and not is_sil_phoneme(cur_ph):
            mel2ph[s:e] = i_ph
            i_itv += 1
        elif not is_sil_phoneme(itv.mark) and is_sil_phoneme(cur_ph):
            i_ph += 1
        else:
            mel2ph[s:e] = i_ph + 1
            i_ph += 1
            i_itv += 1
    if n_frames >= 2:
        mel2ph[-1] = mel2ph[-2]
    dur = mel2ph_to_dur(torch.as_tensor(mel2ph)[None],
                        len(ph_list))[0].numpy()
    return mel2ph, dur
