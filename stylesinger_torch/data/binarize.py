"""Offline binarizer: metadata.json -> IndexedDataset + TSD shards (port of
``stylesinger_tpu/data/binarize.py``).

``StyleSingingBinarizer(cfg, device)``:
- loads ``<processed_data_dir>/metadata.json`` (items with ``item_name``,
  ``ph``, ``ph_durs`` in seconds, ``wav_fn``, ``singer`` and the MIDI
  streams ``ep_pitches`` / ``ep_notedurs`` / ``ep_types``) and splits it
  by item-name substrings (test names leave train);
- per item on ``device``: the log-mel through ``dsp/mel.py::wav2spec``
  (the mel kernel on the card, its plain twin on the CPU), F0 through
  ``dsp/pitch.py::extract_pitch`` (or the cached ``<wav>.npy``), the
  speaker and emotion d-vectors through ``UtteranceEncoder``, and on the
  host ``mel2ph`` from the cumulative ``ph_durs`` and the phone tokens;
- writes ``{prefix}.data/.idx`` (pickled items), ``{prefix}.tsidx/.tsdata``
  when ``write_tsd``, ``{prefix}_lengths.npy``, ``phone_set.json`` and
  ``spec_stats.json`` as the JAX package writes them.

Every stored field is numpy on the host (or a Python list / scalar), so
the shards do not depend on the device and the JAX package reads them.
``stage_seconds`` sums each stage's host-clock seconds; each stage ends in
a copy to the host, so no extra synchronization is needed.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from stylesinger_torch.convert import from_jax_params, load_ge2e_checkpoint
from stylesinger_torch.data.indexed_dataset import IndexedDatasetBuilder
from stylesinger_torch.data.native_loader import TsdWriter
from stylesinger_torch.data.tsd_dataset import precompute_item_fields
from stylesinger_torch.dsp.mel import load_wav, wav2spec
from stylesinger_torch.dsp.pitch import extract_pitch
from stylesinger_torch.inference import init_random_, resolve_device
from stylesinger_torch.models.encoders import UtteranceEncoder, preprocess_wav
from stylesinger_torch.text import TokenTextEncoder, build_token_encoder


def mel2ph_from_ph_durs(ph_durs, n_frames: int, hop_size: int,
                        sample_rate: int) -> np.ndarray:
    """Cumulative-time rounding of per-phone durations (seconds) to a
    1-based frame map, as the reference's ``process_align``."""
    mel2ph = np.zeros([n_frames], np.int64)
    start = 0.0
    for i, d in enumerate(ph_durs):
        s = int(start * sample_rate / hop_size + 0.5)
        e = int((start + d) * sample_rate / hop_size + 0.5)
        mel2ph[s:e] = i + 1
        start += d
    return mel2ph


class StyleSingingBinarizer:
    """See the module docstring.  The GE2E encoders load the files of
    ``speaker_encoder_path`` / ``emotion_encoder_path``; without one, an
    encoder gets seeded random weights (seeds 0 and 1; JAX's
    ``PRNGKey(0)`` / ``(1)`` flax init cannot be replayed)."""

    def __init__(self, cfg: Any, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.processed_dir = cfg["processed_data_dir"]
        self.binary_dir = cfg["binary_data_dir"]
        self.items: Dict[str, Dict] = {}
        self.item_names: List[str] = []
        self._spk_enc: Optional[UtteranceEncoder] = None
        self._emo_enc: Optional[UtteranceEncoder] = None
        self.ph_encoder: Optional[TokenTextEncoder] = None
        self.stage_seconds: Dict[str, float] = collections.defaultdict(float)

    # ---------------------------------------------------------------- meta
    def load_meta_data(self) -> None:
        with open(os.path.join(self.processed_dir, "metadata.json")) as f:
            rows = json.load(f)
        for r in rows:
            self.items[r["item_name"]] = r
            self.item_names.append(r["item_name"])
        self.train_names, self.test_names, self.valid_names = \
            self.split_train_test_set(self.item_names)

    def split_train_test_set(self, names: List[str]
                             ) -> Tuple[List[str], List[str], List[str]]:
        c = self.cfg
        test = [x for x in names
                if any(ts in x for ts in c["test_prefixes"])]
        valid = [x for x in names
                 if any(ts in x for ts in c["valid_prefixes"])]
        train = [x for x in names if x not in set(test)]
        return train, test, valid

    def _build_ph_encoder(self) -> TokenTextEncoder:
        fn = os.path.join(self.processed_dir, "phone_set.json")
        if os.path.exists(fn):
            with open(fn) as f:
                phones = json.load(f)
        else:
            phones = sorted({p for it in self.items.values()
                             for p in it["ph"]})
            with open(fn, "w") as f:
                json.dump(phones, f)  # JSON's default ensure_ascii, as JAX
        return build_token_encoder(phones)

    # ---------------------------------------------------------------- item
    def _timed(self, stage: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.stage_seconds[stage] += t1 - t0
        return t1

    def process_item(self, item: Dict) -> Optional[Dict]:
        c = self.cfg
        item = dict(item)
        wav_fn = item["wav_fn"]
        t = time.perf_counter()
        wav = load_wav(wav_fn, c["audio_sample_rate"])
        t = self._timed("wav_load", t)
        spec = wav2spec(
            wav, self.device, sample_rate=c["audio_sample_rate"],
            n_fft=c["fft_size"], hop_size=c["hop_size"],
            win_length=c["win_size"], n_mels=c["audio_num_mel_bins"],
            fmin=c["fmin"], fmax=c["fmax"])
        mel = spec["mel"].cpu().numpy()
        t = self._timed("mel", t)
        item["mel"] = mel
        item["wav"] = spec["wav"]
        item["len"] = mel.shape[0]
        item["sec"] = len(spec["wav"]) / c["audio_sample_rate"]
        ph = item["ph"]
        item["ph_token"] = self.ph_encoder.encode(
            " ".join(ph) if isinstance(ph, (list, tuple)) else ph)

        f0_cache = re.sub(r"\.wav$", ".npy", wav_fn)
        if os.path.exists(f0_cache):
            f0 = np.load(f0_cache)[: mel.shape[0]]
        else:
            # zero-padded to JAX's length bucket: the Viterbi backtrace
            # starts at the last frame, so another pad could change the
            # decisions at real frames; the pad frames are dropped below
            w = spec["wav"]
            bucket = 4 * c["hop_size"] * 64
            n = -(-len(w) // bucket) * bucket
            w = np.pad(w, (0, n - len(w)))
            f0 = extract_pitch(w, hop_size=c["hop_size"],
                               sample_rate=c["audio_sample_rate"],
                               device=self.device)
            f0 = f0[: mel.shape[0]]
        if len(f0) < mel.shape[0]:
            f0 = np.pad(f0, (0, mel.shape[0] - len(f0)), mode="edge")
        item["f0"] = f0
        self._timed("f0", t)

        item["mel2ph"] = mel2ph_from_ph_durs(
            item["ph_durs"], mel.shape[0], c["hop_size"],
            c["audio_sample_rate"])
        return item

    def _encoder(self, key: str, what: str, seed: int) -> UtteranceEncoder:
        enc = UtteranceEncoder()
        path = self.cfg.get(key) or ""
        if path and os.path.exists(path):
            enc.load_state_dict(from_jax_params(load_ge2e_checkpoint(path)))
        else:
            if path:
                print(f"| WARN: {key} {path} missing; random {what}-encoder "
                      "weights")
            init_random_(enc, torch.Generator().manual_seed(seed))
        return enc.to(self.device).eval()

    def _ensure_encoders(self) -> None:
        if self._spk_enc is None:
            self._spk_enc = self._encoder("speaker_encoder_path", "speaker", 0)
        if self._emo_enc is None:
            self._emo_enc = self._encoder("emotion_encoder_path", "emotion", 1)

    def _embed(self, wav48: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Speaker + emotion d-vectors as the reference binarizer makes
        them: the speaker embed from the native-rate wav fed straight into
        the 16 kHz front-end (a reference quirk kept for checkpoint parity,
        cfg ``spk_embed_at_native_rate``), the emotion embed from the
        preprocessed 16 kHz wav.  The LSTMs run in f32 whatever the
        process's TF32 switch: with cuDNN's TF32 (PyTorch's default) the
        d-vectors move by about 1e-4, so shards would depend on it."""
        c = self.cfg
        self._ensure_encoders()
        t = time.perf_counter()
        wav16 = preprocess_wav(wav48, c["audio_sample_rate"])
        if c.get("spk_embed_at_native_rate", True):
            spk_wav = np.asarray(wav48, np.float32)
        else:
            spk_wav = wav16
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            spk = self._spk_enc.embed_utterance(spk_wav, project=True)
            t = self._timed("spk_embed", t)
            emo = self._emo_enc.embed_utterance(wav16, project=False)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        self._timed("emo_embed", t)
        return spk, emo

    # ------------------------------------------------------------- process
    def process(self) -> None:
        self.load_meta_data()
        os.makedirs(self.binary_dir, exist_ok=True)
        self.ph_encoder = self._build_ph_encoder()
        shutil.copy(os.path.join(self.processed_dir, "phone_set.json"),
                    os.path.join(self.binary_dir, "phone_set.json"))
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)

    def process_data(self, prefix: str) -> None:
        c = self.cfg
        names = {"valid": self.valid_names, "test": self.test_names,
                 "train": self.train_names}[prefix]
        builder = IndexedDatasetBuilder(os.path.join(self.binary_dir, prefix))
        tsd = TsdWriter(os.path.join(self.binary_dir, prefix)) \
            if c.get("write_tsd", True) else None
        lengths, total_sec = [], 0.0
        spec_min = np.full(c["audio_num_mel_bins"], np.inf, np.float32)
        spec_max = np.full(c["audio_num_mel_bins"], -np.inf, np.float32)
        ba = c["binarization_args"]
        for name in names:
            item = self.process_item(self.items[name])
            if item is None:
                print(f"| skip corrupt item {name}")
                continue
            if ba.get("with_spk_embed") or ba.get("with_emotion"):
                spk, emo = self._embed(item["wav"])
                if ba.get("with_spk_embed"):
                    item["spk_embed"] = spk
                if ba.get("with_emotion"):
                    item["emo_embed"] = emo
            if not ba.get("with_wav", False):
                item.pop("wav", None)
            t = time.perf_counter()
            lengths.append(item["len"])
            total_sec += item["sec"]
            spec_min = np.minimum(spec_min, item["mel"].min(0))
            spec_max = np.maximum(spec_max, item["mel"].max(0))
            builder.add_item(item)
            if tsd is not None:
                fast = precompute_item_fields(item, c)
                tsd.add_item({k: v for k, v in fast.items()
                              if isinstance(v, (np.ndarray, list, int,
                                                float))
                              and not isinstance(v, bool)})
            self._timed("shard_write", t)
        t = time.perf_counter()
        builder.finalize()
        if tsd is not None:
            tsd.finalize()
        np.save(os.path.join(self.binary_dir, f"{prefix}_lengths.npy"),
                lengths)
        if prefix == "train" and lengths:
            # per-dataset diffusion bounds; read when the config sets
            # use_data_spec_stats (config.py::apply_spec_stats)
            with open(os.path.join(self.binary_dir,
                                   "spec_stats.json"), "w") as f:
                json.dump({"spec_min": spec_min.tolist(),
                           "spec_max": spec_max.tolist()}, f)
        self._timed("shard_write", t)
        print(f"| {prefix}: {len(lengths)} items, {total_sec:.1f}s audio")


# the binarizer classes that ``binarizer_cls`` may name: the JAX package's
# name (the recipe's, egs/stylesinger.yaml) resolves to the port's own
# class, and its module is never imported
BINARIZERS = {
    "stylesinger_tpu.data.binarize.StyleSingingBinarizer":
        StyleSingingBinarizer,
    "stylesinger_torch.data.binarize.StyleSingingBinarizer":
        StyleSingingBinarizer,
}


def resolve_binarizer_cls(cls_path: str):
    """The port's class for a ``binarizer_cls`` path; raises ``ValueError``
    for a path it does not know."""
    try:
        return BINARIZERS[cls_path]
    except KeyError:
        raise ValueError(f"unknown binarizer_cls {cls_path!r}; known: "
                         f"{sorted(BINARIZERS)}") from None


def binarize(cfg: Any, device: Union[str, torch.device] = "cuda"
             ) -> StyleSingingBinarizer:
    """``run.py binarize``: the ``binarizer_cls`` of ``cfg`` over its
    corpus on ``device``; returns the binarizer."""
    binarizer = resolve_binarizer_cls(cfg["binarizer_cls"])(cfg,
                                                            device=device)
    binarizer.process()
    return binarizer
