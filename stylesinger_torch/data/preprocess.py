"""Raw-corpus preprocessor: text normalization + g2p -> metadata.json
(port of ``stylesinger_tpu/data/preprocess.py``; host Python and numpy).

Parity target: ``BasePreprocessor``
(``data_gen/tts/base_preprocess.py:34-152`` in AaronZ345/StyleSinger): walk
raw items (txt, wav_fn, singer, optional MIDI streams), run the language's
text processor, build the phone set, and write
``<processed_data_dir>/metadata.json`` + ``phone_set.json`` for the
binarizer.  Wav processors are a registry of callables
(``data_gen/tts/wav_processors``), here simple numpy hooks.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from stylesinger_torch.text_processors import get_txt_processor_cls

REGISTERED_WAV_PROCESSORS: Dict[str, Callable] = {}


def register_wav_processor(name: str):
    def wrap(fn):
        REGISTERED_WAV_PROCESSORS[name] = fn
        return fn
    return wrap


@register_wav_processor("trim_sil")
def _trim_sil(wav: np.ndarray, sr: int) -> np.ndarray:
    from stylesinger_torch.dsp.vad import trim_long_silences
    return trim_long_silences(wav, sr)[0]


@register_wav_processor("norm_volume")
def _norm_volume(wav: np.ndarray, sr: int, target_dbfs: float = -30.0
                 ) -> np.ndarray:
    rms = np.sqrt((wav ** 2).mean() + 1e-12)
    gain = 10 ** (target_dbfs / 20) / max(rms, 1e-8)
    return np.clip(wav * gain, -1.0, 1.0)


@register_wav_processor("denoise")
def _denoise(wav: np.ndarray, sr: int, strength: float = 0.01) -> np.ndarray:
    """Spectral noise-floor suppression for raw recordings (stands in for
    the reference's external rnnoise/sox denoise hook,
    data_gen/tts/wav_processors/common_processors.py), on the host."""
    import torch

    from stylesinger_torch.dsp.denoise import denoise as _spectral_denoise

    n = len(wav)
    padded = np.pad(np.asarray(wav, np.float32), (0, 1024))
    out = _spectral_denoise(torch.as_tensor(padded), strength)
    return out[:n].numpy().astype(np.float32)


class Preprocessor:
    def __init__(self, cfg: Any, language: str = "zh"):
        self.cfg = cfg
        self.txt_processor = get_txt_processor_cls(language)

    def process_item(self, item: Dict) -> Optional[Dict]:
        """One raw item -> processed metadata row (ph list from g2p unless
        already provided, as in GTSinger-style corpora)."""
        out = dict(item)
        if "ph" not in out or not out["ph"]:
            phs, norm_txt = self.txt_processor.process(out["txt"])
            out["ph"] = phs
            out["txt"] = norm_txt
        elif isinstance(out["ph"], str):
            out["ph"] = out["ph"].split(" ")
        return out

    def process(self, items: List[Dict],
                out_dir: Optional[str] = None) -> List[Dict]:
        out_dir = out_dir or self.cfg["processed_data_dir"]
        os.makedirs(out_dir, exist_ok=True)
        rows = []
        for item in items:
            row = self.process_item(item)
            if row is not None:
                rows.append(row)
        phones = sorted({p for r in rows for p in r["ph"]})
        json.dump(phones, open(os.path.join(out_dir, "phone_set.json"),
                               "w"), ensure_ascii=False)
        json.dump(rows, open(os.path.join(out_dir, "metadata.json"), "w"),
                  ensure_ascii=False)
        print(f"| preprocess: {len(rows)} items, {len(phones)} phones")
        return rows

    def build_mfa_inputs(self, rows: List[Dict],
                         out_dir: Optional[str] = None) -> str:
        """Lay out a Montreal-Forced-Aligner corpus from processed rows
        (reference ``BasePreprocessor.build_mfa_inputs``,
        data_gen/tts/base_preprocess.py + ``train_mfa_align.py``):
        ``mfa_inputs/<group>/<item>.{wav,lab}`` with space-joined phones as
        the transcript, plus ``mfa_dict.txt`` mapping each phone to itself.
        MFA's TextGrid output then feeds ``dsp/textgrid_align.py``."""
        import shutil

        out_dir = out_dir or self.cfg["processed_data_dir"]
        mfa_dir = os.path.join(out_dir, "mfa_inputs")
        os.makedirs(mfa_dir, exist_ok=True)
        phones = set()
        for row in rows:
            group = str(row.get("singer", row.get("spk_name", "spk0")))
            gdir = os.path.join(mfa_dir, group)
            os.makedirs(gdir, exist_ok=True)
            name = row["item_name"]
            ph = row["ph"] if isinstance(row["ph"], list) else \
                row["ph"].split(" ")
            phones.update(ph)
            with open(os.path.join(gdir, f"{name}.lab"), "w") as f:
                f.write(" ".join(ph))
            if row.get("wav_fn") and os.path.exists(row["wav_fn"]):
                dst = os.path.join(gdir, f"{name}.wav")
                if os.path.abspath(row["wav_fn"]) != os.path.abspath(dst):
                    shutil.copyfile(row["wav_fn"], dst)
        with open(os.path.join(out_dir, "mfa_dict.txt"), "w") as f:
            for p in sorted(phones):
                f.write(f"{p} {p}\n")
        return mfa_dir


# ---------------------------------------------------------------------------
# Dataset meta-data adapters (reference egs/datasets/audio/*/pre_align.py):
# each yields raw-item dicts {item_name, wav_fn, txt, spk_name[, emotion]}
# for Preprocessor.process. Registered by name so recipes can select one
# via cfg `pre_align_cls` exactly like the reference's binarizer_cls.
# ---------------------------------------------------------------------------

META_ADAPTERS: Dict[str, Any] = {}


def register_meta_adapter(name: str):
    def wrap(fn):
        META_ADAPTERS[name] = fn
        return fn
    return wrap


@register_meta_adapter("lj")
def lj_meta_data(raw_data_dir: str):
    """LJSpeech metadata.csv: item|raw|normalized text, single speaker
    (egs/datasets/audio/lj/pre_align.py)."""
    for line in open(os.path.join(raw_data_dir, "metadata.csv"),
                     encoding="utf-8"):
        parts = line.strip().split("|")
        if len(parts) < 3:
            continue
        item_name, _, txt = parts[0], parts[1], parts[2]
        yield {"item_name": item_name,
               "wav_fn": os.path.join(raw_data_dir, "wavs",
                                      f"{item_name}.wav"),
               "txt": txt, "spk_name": "SPK1"}


@register_meta_adapter("emotion")
def emotion_meta_data(raw_data_dir: str):
    """ESD-style layout: <spk>/<spk>.txt lines 'item txt... emotion lang',
    wavs under <spk>/<emotion>/ (egs/datasets/audio/emotion/pre_align.py)."""
    import re

    pattern = re.compile(r"[\t\n ]+")
    spks = sorted(d for d in os.listdir(raw_data_dir)
                  if os.path.isdir(os.path.join(raw_data_dir, d)))
    for spk in spks:
        index = os.path.join(raw_data_dir, spk, f"{spk}.txt")
        if not os.path.exists(index):
            continue
        for line in open(index, encoding="utf-8"):
            # reference slicing relies on the trailing '' produced by the
            # newline->space substitution: [item, txt..., emotion, ''] —
            # synthesize the sentinel when the last line lacks a newline
            line = re.sub(pattern, " ", line)
            if line.strip() == "":
                continue
            if not line.endswith(" "):
                line += " "
            split_ = line.split(" ")
            item_name, txt = split_[0], " ".join(split_[1:-2])
            emotion = split_[-2]
            yield {"item_name": item_name,
                   "wav_fn": os.path.join(raw_data_dir, spk, emotion,
                                          f"{item_name}.wav"),
                   "txt": txt, "spk_name": spk, "emotion": emotion}


@register_meta_adapter("libritts")
def libritts_meta_data(raw_data_dir: str):
    """LibriTTS: */*/*.wav with sibling .normalized.txt; speaker = first
    item-name field (egs/datasets/audio/libritts/pre_align.py)."""
    import glob

    for wav_fn in sorted(glob.glob(os.path.join(raw_data_dir, "*", "*",
                                                "*.wav"))):
        item_name = os.path.basename(wav_fn)[:-4]
        txt_fn = wav_fn[:-4] + ".normalized.txt"
        if not os.path.exists(txt_fn):
            continue
        with open(txt_fn, encoding="utf-8") as f:
            txt = f.readline().strip()
        yield {"item_name": item_name, "wav_fn": wav_fn, "txt": txt,
               "spk_name": item_name.split("_")[0]}


@register_meta_adapter("vctk")
def vctk_meta_data(raw_data_dir: str):
    """VCTK: wav48/<spk>/*.wav with transcripts under txt/<spk>/
    (egs/datasets/audio/vctk/pre_align.py)."""
    import glob

    for wav_fn in sorted(glob.glob(os.path.join(raw_data_dir, "wav48", "*",
                                                "*.wav"))):
        item_name = os.path.basename(wav_fn)[:-4]
        spk = item_name.split("_")[0]
        txt_fn = os.path.join(raw_data_dir, "txt", spk, f"{item_name}.txt")
        if not os.path.exists(txt_fn):
            continue
        with open(txt_fn, encoding="utf-8") as f:
            txt = f.read().strip()
        yield {"item_name": item_name, "wav_fn": wav_fn, "txt": txt,
               "spk_name": spk}


def load_meta_data(name: str, raw_data_dir: str):
    """Materialize a registered adapter's rows."""
    return list(META_ADAPTERS[name](raw_data_dir))
