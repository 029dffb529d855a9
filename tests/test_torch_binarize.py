"""Raw corpus -> metadata.json -> shards: the port's ``Preprocessor`` and
``StyleSingingBinarizer`` against the JAX package's, on the CPU.

A 4-item corpus (1-2 s harmonic voices on MIDI notes at 16 kHz, hanzi
``txt`` without phones, so the zh processor gives them) goes through both
packages' preprocess and binarize once per module, the GE2E encoders of
both given the same files in the reference layout.  Every shard is held
field for field and dtype for dtype: ints and strings exactly; the mel,
F0 and d-vectors at atol 2e-4 / rtol 2e-3 (``tests/test_convert.py``),
the F0's voicing exactly.  Then each package reads the other's shards,
and the CLI (``run.py preprocess|binarize --device cpu``) writes what the
in-process binarizer writes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config as jax_tiny
from stylesinger_tpu.data import StyleSingerDataset as JaxDataset
from stylesinger_tpu.data.binarize import (
    StyleSingingBinarizer as JaxBinarizer,
)
from stylesinger_tpu.data.indexed_dataset import IndexedDataset as JaxIndexed
from stylesinger_tpu.data.preprocess import Preprocessor as JaxPreprocessor

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.data import binarize as tb
from stylesinger_torch.data.dataset import StyleSingerDataset
from stylesinger_torch.data.indexed_dataset import IndexedDataset
from stylesinger_torch.data.preprocess import Preprocessor
from stylesinger_torch.dsp.mel import save_wav
from stylesinger_torch.text_processors import get_txt_processor_cls

REPO = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-4, 2e-3
SR = 16000
AUDIO = dict(audio_sample_rate=SR, fft_size=512, win_size=512, hop_size=128,
             fmax=8000, max_frames=256, test_prefixes=["test_"],
             valid_prefixes=["valid_"])
TEXTS = ["月亮代表我的心", "我爱你", "小酒窝长睫毛", "你好世界"]
NAMES = ["s1_0", "test_s2_1", "valid_s1_2", "s3_3"]
FLOAT_FIELDS = ("mel", "f0", "spk_embed", "emo_embed")


def write_raw_corpus(root: Path, n: int = 4, seed: int = 0) -> Path:
    """Raw rows (no ``ph``; ``ph_durs`` for the zh processor's phones,
    summing to the wav's length) and their 16-bit wavs; returns the
    ``metadata.json``'s directory."""
    rng = np.random.default_rng(seed)
    proc = get_txt_processor_cls("zh")
    raw = root / "raw"
    raw.mkdir(parents=True)
    rows = []
    for i in range(n):
        n_ph = len(proc.process(TEXTS[i])[0])
        dur = float(rng.uniform(1.0, 2.0))
        cuts = np.sort(rng.uniform(0.1, 0.9, n_ph - 1)) * dur
        ph_durs = np.diff(np.concatenate([[0.0], cuts, [dur]])).tolist()
        notes = rng.integers(55, 76, n_ph)
        t = np.arange(int(dur * SR)) / SR
        f0 = 440.0 * 2 ** ((notes[np.minimum(
            np.searchsorted(np.cumsum(ph_durs), t, side="right"),
            n_ph - 1)] - 69) / 12)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        wav = sum(rng.uniform(0.2, 1.0) / h * np.sin(h * phase)
                  for h in range(1, 6))
        env = np.minimum(1.0, np.minimum(t, dur - t) / 0.05)
        wav = 0.3 * wav * env / np.abs(wav).max() + \
            0.003 * rng.standard_normal(len(t))
        wav_fn = str(raw / f"{NAMES[i]}.wav")
        save_wav(wav.astype(np.float32), wav_fn, SR)
        rows.append(dict(item_name=NAMES[i], txt=TEXTS[i], wav_fn=wav_fn,
                         singer=NAMES[i].split("_")[-2], ph_durs=ph_durs,
                         ep_pitches=notes.tolist(), ep_notedurs=ph_durs,
                         ep_types=[2] * n_ph))
    with open(raw / "metadata.json", "w") as f:
        json.dump(rows, f, ensure_ascii=False)
    return raw


class ReferenceGE2E(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = torch.nn.LSTM(40, 256, 3, batch_first=True)
        self.linear = torch.nn.Linear(256, 256)


def ge2e_file(path: Path, seed: int) -> str:
    torch.manual_seed(seed)
    torch.save({"model_state": ReferenceGE2E().state_dict(), "step": 1},
               path)
    return str(path)


def paths(root: Path, side: str, raw: Path, ge2e: dict) -> dict:
    return dict(raw_data_dir=str(raw),
                processed_data_dir=str(root / side / "processed"),
                binary_data_dir=str(root / side / "binary"), **ge2e)


class Recording(dict):
    """A config that records the defaults of each ``cfg.get``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seen = {}

    def get(self, key, default=None):
        self.seen[key] = default
        return dict.get(self, key, default)


def jitted_ge2e_apply():
    """JAX's binarizer applies its GE2E encoders eagerly, op by op (1.2 s a
    call here); the same ``apply`` jitted once per (partials, project)
    shape gives the same numbers in a fraction of the time."""
    import functools

    import jax

    from stylesinger_tpu.models.encoders import UtteranceEncoder

    original = UtteranceEncoder._apply_bucketed
    jitted = {}
    module = UtteranceEncoder(parent=None)

    def apply(self, variables, partials, project):
        if project not in jitted:
            jitted[project] = jax.jit(functools.partial(module.apply,
                                                        project=project))
        p = partials.shape[0]
        bucket = 1 << (p - 1).bit_length()
        padded = np.pad(partials, ((0, bucket - p), (0, 0), (0, 0)))
        return np.asarray(jitted[project](variables, padded))[:p]

    return UtteranceEncoder, original, apply


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("binarize")
    raw = write_raw_corpus(root)
    ge2e = dict(speaker_encoder_path=ge2e_file(root / "pretrained.pt", 1),
                emotion_encoder_path=ge2e_file(root / "global.pt", 2))
    with open(raw / "metadata.json") as f:
        rows = json.load(f)
    jcfg = Recording(jax_tiny(**AUDIO, **paths(root, "jax", raw, ge2e)))
    JaxPreprocessor(jcfg).process(rows)
    encoder_cls, original, apply = jitted_ge2e_apply()
    encoder_cls._apply_bucketed = apply
    try:
        JaxBinarizer(jcfg).process()
    finally:
        encoder_cls._apply_bucketed = original
    tcfg = torch_tiny(**AUDIO, **paths(root, "torch", raw, ge2e))
    Preprocessor(tcfg).process(rows)
    binarizer = tb.StyleSingingBinarizer(tcfg, device="cpu")
    binarizer.process()
    return dict(root=root, raw=raw, ge2e=ge2e, jcfg=jcfg, tcfg=tcfg,
                jax=root / "jax", torch=root / "torch",
                stages=dict(binarizer.stage_seconds))


def _items(reader_cls, path):
    ds = reader_cls(str(path))
    return [ds[i] for i in range(len(ds))]


def assert_item_equal(a: dict, b: dict, exact_floats: bool = False):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        assert type(x) is type(y), k
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if k in FLOAT_FIELDS and not exact_floats:
                np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL,
                                           err_msg=k)
                if k == "f0":
                    np.testing.assert_array_equal(x > 0, y > 0)
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def test_preprocess_writes_the_same_metadata_and_phone_set(corpus):
    for name in ("metadata.json", "phone_set.json"):
        assert (corpus["torch"] / "processed" / name).read_bytes() == \
            (corpus["jax"] / "processed" / name).read_bytes()
    with open(corpus["torch"] / "processed" / "metadata.json") as f:
        rows = json.load(f)
    for row in rows:  # the processor's phones, one per duration
        assert len(row["ph"]) == len(row["ph_durs"]) > 0
    assert (corpus["torch"] / "binary" / "phone_set.json").read_bytes() == \
        (corpus["jax"] / "binary" / "phone_set.json").read_bytes()


@pytest.mark.parametrize("prefix", ["valid", "test", "train"])
def test_shards_equal_jax_field_for_field(corpus, prefix):
    ours = _items(IndexedDataset, corpus["torch"] / "binary" / prefix)
    ref = _items(JaxIndexed, corpus["jax"] / "binary" / prefix)
    want = {"valid": 1, "test": 1, "train": 3}[prefix]
    assert len(ours) == len(ref) == want
    for a, b in zip(ours, ref):
        assert_item_equal(a, b)
        assert a["mel"].dtype == np.float32 and a["mel2ph"].dtype == np.int64
        assert a["mel"].shape[1] == corpus["tcfg"]["audio_num_mel_bins"]
        assert a["mel2ph"].max() == len(a["ph_token"])
        assert (a["f0"] > 0).mean() > 0.5
        assert np.abs(a["spk_embed"]).max() > 0 < np.abs(a["emo_embed"]).max()
    np.testing.assert_array_equal(
        np.load(corpus["torch"] / "binary" / f"{prefix}_lengths.npy"),
        np.load(corpus["jax"] / "binary" / f"{prefix}_lengths.npy"))


def test_spec_stats_and_tsd_index_equal_jax(corpus):
    with open(corpus["torch"] / "binary" / "spec_stats.json") as f:
        ours = json.load(f)
    with open(corpus["jax"] / "binary" / "spec_stats.json") as f:
        ref = json.load(f)
    for k in ("spec_min", "spec_max"):
        np.testing.assert_allclose(ours[k], ref[k], atol=ATOL, rtol=RTOL)
    for prefix in ("valid", "test", "train"):
        for ext in (".tsidx", ".data", ".tsdata"):
            a = corpus["torch"] / "binary" / (prefix + ext)
            b = corpus["jax"] / "binary" / (prefix + ext)
            if ext == ".tsidx":  # names, dtypes, shapes and offsets
                assert a.read_bytes() == b.read_bytes()
            else:
                assert a.stat().st_size == b.stat().st_size


def test_tsd_files_byte_equal_given_equal_items(corpus, tmp_path):
    """The port's binarizer writes JAX's TSD bytes from JAX's items."""
    from stylesinger_tpu.data.native_loader import TsdWriter as JaxWriter
    from stylesinger_tpu.data.tsd_dataset import (
        precompute_item_fields as jax_fields,
    )

    from stylesinger_torch.data.native_loader import TsdWriter
    from stylesinger_torch.data.tsd_dataset import precompute_item_fields

    items = _items(JaxIndexed, corpus["jax"] / "binary" / "train")

    def keep(fast):
        return {k: v for k, v in fast.items()
                if isinstance(v, (np.ndarray, list, int, float))
                and not isinstance(v, bool)}

    for name, writer, fields in (("ours", TsdWriter, precompute_item_fields),
                                 ("ref", JaxWriter, jax_fields)):
        w = writer(str(tmp_path / name))
        for item in items:
            w.add_item(keep(fields(item, corpus["jcfg"])))
        w.finalize()
    for ext in (".tsidx", ".tsdata"):
        assert (tmp_path / f"ours{ext}").read_bytes() == \
            (tmp_path / f"ref{ext}").read_bytes()
    assert (tmp_path / "ref.tsdata").read_bytes() == \
        (corpus["jax"] / "binary" / "train.tsdata").read_bytes()


def test_tsd_shards_read_back_the_indexed_items(corpus):
    """Every TSD field is the IndexedDataset item's, plus f0_norm / uv."""
    from stylesinger_torch.data.native_loader import TsdReader
    from stylesinger_torch.dsp.pitch import norm_interp_f0_np

    c = corpus["tcfg"]
    for prefix in ("valid", "test", "train"):
        path = corpus["torch"] / "binary" / prefix
        items = _items(IndexedDataset, path)
        reader = TsdReader(str(path))
        assert len(reader) == len(items)
        for i, item in enumerate(items):
            for k in ("mel", "f0", "mel2ph", "wav", "spk_embed",
                      "emo_embed"):
                np.testing.assert_array_equal(reader.field(i, k), item[k])
            for k in ("ph_token", "ep_pitches", "ep_types", "ph_durs",
                      "len", "sec"):  # a scalar as a 1-element array
                np.testing.assert_array_equal(reader.field(i, k),
                                              np.atleast_1d(item[k]))
            f0, uv = norm_interp_f0_np(item["f0"], pitch_norm=c["pitch_norm"],
                                       use_uv=c["use_uv"],
                                       f0_mean=c["f0_mean"],
                                       f0_std=c["f0_std"])
            np.testing.assert_array_equal(reader.field(i, "f0_norm"), f0)
            np.testing.assert_array_equal(reader.field(i, "uv"), uv)
        reader.close()


@pytest.mark.parametrize("prefix", ["test", "train"])
def test_each_package_reads_the_others_shards(corpus, prefix):
    jcfg, tcfg = corpus["jcfg"], corpus["tcfg"]
    for cfg, ds_cls, side in ((jcfg, JaxDataset, "torch"),
                              (tcfg, StyleSingerDataset, "jax")):
        other = ds_cls(cfg, prefix, data_dir=str(corpus[side] / "binary"))
        own = ds_cls(cfg, prefix,
                     data_dir=str(corpus["jax" if side == "torch"
                                         else "torch"] / "binary"))
        assert len(other) == len(own) > 0 and other.sizes == own.sizes
        for i in range(len(other)):
            a, b = other[i], own[i]
            assert sorted(a) == sorted(b)
            for k in ("txt_tokens", "mel2ph", "uv", "notes", "note_types"):
                np.testing.assert_array_equal(a[k], b[k])
            for k in ("mels", "f0", "spk_embed", "emo_embed"):
                np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL)


def test_binarizer_records_jax_defaults_and_resolves_its_class(corpus):
    """``write_tsd`` defaults to what JAX's binarizer passes its
    ``cfg.get``; the recipe's ``binarizer_cls`` names the JAX class, which
    resolves to the port's; an unknown path raises."""
    from stylesinger_torch.config import READ_WITH_GET_DATA, load_config

    assert corpus["jcfg"].seen["write_tsd"] == \
        READ_WITH_GET_DATA["write_tsd"] is True
    cfg = load_config(recipe="stylesinger")
    assert cfg["write_tsd"] is True and load_config()["write_tsd"] is True
    assert tb.resolve_binarizer_cls(cfg["binarizer_cls"]) is \
        tb.StyleSingingBinarizer
    with pytest.raises(ValueError, match="unknown binarizer_cls"):
        tb.resolve_binarizer_cls("somewhere.else.Binarizer")
    # with stylesinger_tpu blocked: tests/test_torch_imports.py


def test_binarize_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.StyleSingingBinarizer(torch_tiny())


def _hparams(d: dict) -> str:
    parts = []
    for k, v in d.items():
        if isinstance(v, (list, tuple)):
            v = "[" + ",".join(json.dumps(x) for x in v) + "]"
        parts.append(f"{k}={v}")
    return ",".join(parts)


def tiny_overrides(cfg) -> dict:
    """The keys in which the tiny config differs from the defaults."""
    from stylesinger_torch.config import load_config

    base = load_config()
    keys = [k for k in cfg if k not in ("spec_min", "spec_max")
            and json.dumps(cfg[k]) != json.dumps(base.get(k))]
    return {k: cfg[k] for k in keys}


def test_cli_preprocess_and_binarize_write_the_in_process_shards(
        corpus, tmp_path):
    """``run.py preprocess`` then ``python -m stylesinger_torch.run
    binarize --device cpu`` (its own process), equal to the in-process
    binarizer's shards byte for byte (same device, weights and order of
    operations); without ``--device`` it refuses here."""
    from stylesinger_torch import run

    cfg = dict(tiny_overrides(corpus["tcfg"]),
               **paths(tmp_path, "cli", corpus["raw"], corpus["ge2e"]))
    hp = _hparams(cfg)
    assert run.main(["preprocess", "--hparams", hp]) == 0
    out = subprocess.run(
        [sys.executable, "-m", "stylesinger_torch.run", "binarize",
         "--device", "cpu", "--hparams", hp], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ours, ref = tmp_path / "cli" / "binary", corpus["torch"] / "binary"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for prefix in ("valid", "test", "train"):
        for a, b in zip(_items(IndexedDataset, ours / prefix),
                        _items(IndexedDataset, ref / prefix)):
            a.pop("wav_fn"), b.pop("wav_fn")
            assert_item_equal(a, b, exact_floats=True)
        for ext in (".tsidx", ".tsdata"):
            assert (ours / (prefix + ext)).read_bytes() == \
                (ref / (prefix + ext)).read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(["binarize", "--hparams", hp])


def test_mfa_align_refuses_as_jax_does_without_mfa(corpus, tmp_path,
                                                    monkeypatch):
    """``preprocess --mfa`` lays out the same MFA corpus; ``mfa-align``
    then exits with JAX's message when ``mfa`` is not installed."""
    import shutil

    from stylesinger_tpu import run as jax_run

    from stylesinger_torch import run

    if shutil.which("mfa"):
        pytest.skip("Montreal Forced Aligner is installed here")

    def jax_main(argv):
        monkeypatch.setattr(sys, "argv", ["stylesinger_tpu.run", *argv])
        return jax_run.main()

    results = {}
    for side, main in (("jax", jax_main), ("torch", run.main)):
        hp = f"raw_data_dir={corpus['raw']}," \
             f"processed_data_dir={tmp_path / side}"
        main(["preprocess", "--mfa", "--hparams", hp])
        with pytest.raises(SystemExit) as exit_:
            main(["mfa-align", "--hparams", hp])
        results[side] = str(exit_.value.code).replace(str(tmp_path / side),
                                                      "<dir>")
        mfa = tmp_path / side / "mfa_inputs"
        results[side + "_files"] = sorted(
            str(p.relative_to(mfa)) for p in mfa.rglob("*"))
        results[side + "_dict"] = (tmp_path / side /
                                   "mfa_dict.txt").read_text()
    assert results["torch"] == results["jax"]
    assert "not installed" in results["torch"]
    assert results["torch_files"] == results["jax_files"]
    assert results["torch_dict"] == results["jax_dict"]
    for row in json.loads((tmp_path / "torch" / "metadata.json").read_text()):
        group = tmp_path / "torch" / "mfa_inputs" / row["singer"]
        assert (group / f"{row['item_name']}.lab").read_text() == \
            " ".join(row["ph"])


def test_stage_seconds_cover_every_stage(corpus):
    assert set(corpus["stages"]) == {"wav_load", "mel", "f0", "spk_embed",
                                     "emo_embed", "shard_write"}
    assert all(v >= 0 for v in corpus["stages"].values())


def test_phone_set_fallback_writes_jax_bytes(tmp_path):
    """Without a processed ``phone_set.json`` both binarizers write one
    from the items' phones with JSON's default ``ensure_ascii`` (where
    ``preprocess`` writes it with ``ensure_ascii=False``)."""
    items = {"a": {"ph": ["ü", "a", "SP"]}, "b": {"ph": ["é", "a"]}}
    encoders = {}
    for side, cls, kw in (("jax", JaxBinarizer, {}),
                          ("torch", tb.StyleSingingBinarizer,
                           dict(device="cpu"))):
        (tmp_path / side).mkdir()
        b = cls(dict(processed_data_dir=str(tmp_path / side),
                     binary_data_dir=str(tmp_path / side)), **kw)
        b.items = items
        encoders[side] = b._build_ph_encoder()
    text = (tmp_path / "torch" / "phone_set.json").read_text()
    assert text == (tmp_path / "jax" / "phone_set.json").read_text()
    assert "\\u00fc" in text
    assert encoders["torch"].encode("a é ü SP x") == \
        encoders["jax"].encode("a é ü SP x")
