"""The port's text front-end against the JAX package's: the zh, zh_g2pM and
en processors, the Chinese normalizer, the token encoder and the shipped
assets.  Text is compared exactly."""

import sys
from pathlib import Path

import pytest

from stylesinger_tpu import text as jtext
from stylesinger_tpu import text_norm_zh as jnorm
from stylesinger_tpu import text_processors as jtp

from stylesinger_torch import text as ttext
from stylesinger_torch import text_norm_zh as tnorm
from stylesinger_torch import text_processors as ttp

REPO = Path(__file__).resolve().parent.parent

ZH = [
    "月亮代表我的心",
    "我爱你，你爱我吗？",
    "今天是2024年3月15日，气温是-3.5度。",
    "这件衣服卖128.50元，打八折是102.8元！",
    "增长了35%，完成率为99.9%。",
    "请拨打13912345678或010-62345678。",
    "比分是3:2，约1/3的人到了。",
    "第101个人有200000000元",
    "小酒窝长睫毛AP是你最美的记号",
    "他说：“OK，我们走吧”……",
    "xiao3 jiu3 wo1 SP zhang3 jie2 mao2",
    "abc二def和G2P模型",
]
ZH_G2PM = [
    "xiao3 jiu3 wo1 # zhang3 jie2 mao2",
    "wo3 ai4 ni3 # AP # ni3 ai4 wo3",
    "yue4 liang4 # dai4 biao3 # wo3 de5 xin1 SP",
    "ni3 hao3",
]
EN = [
    "Hello world, this is a test.",
    "The quick brown fox jumps over the lazy dog!",
    "Unbelievably, the reorganization's cheerfulness was overwhelming.",
    "Synthesizers and vocoders singing glorpish zyxtrophic melodies",
    "I can't believe it's 2024; it costs $5.",
    "Re-running the un-tokenizable strawberries, thanked & walked.",
]


@pytest.mark.parametrize("name,sentences", [("zh", ZH),
                                            ("zh_g2pM", ZH_G2PM),
                                            ("en", EN)])
def test_processors_give_jax_phones_and_text(name, sentences):
    ours, ref = ttp.get_txt_processor_cls(name), jtp.get_txt_processor_cls(name)
    for s in sentences:
        phs, txt = ours.process(s)
        assert (phs, txt) == ref.process(s), s
        assert phs and all(isinstance(p, str) and p for p in phs)
    assert ours.sp_phonemes() == ref.sp_phonemes()


def test_registry_and_zh_g2pm_raw_hanzi_refusal():
    assert sorted(ttp.REGISTERED_TEXT_PROCESSORS) == \
        sorted(jtp.REGISTERED_TEXT_PROCESSORS)
    for name in ttp.REGISTERED_TEXT_PROCESSORS:
        assert ttp.get_txt_processor_cls(name).__name__ == \
            jtp.get_txt_processor_cls(name).__name__
    errors = []
    for mod in (ttp, jtp):
        try:
            mod.get_txt_processor_cls("zh_g2pM").process("我爱你")
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


def test_en_lexicon_morphology_and_lts_equal_jax():
    lex, jlex = ttp.full_en_lexicon(), jtp.full_en_lexicon()
    assert lex == jlex and len(lex) > 4000
    for word in ("glorpish", "zyxtrophic", "tokenizable", "strawberries",
                 "reorganization", "cheerfulness", "vocoders"):
        assert ttp._letter_to_sound(word) == jtp._letter_to_sound(word), word
        assert ttp._morph_lookup(word, lex) == jtp._morph_lookup(word, jlex)
        assert ttp._lts_model().decode(word) == jtp._lts_model().decode(word)


def test_zh_normalizer_equal_jax():
    for s in ZH:
        assert tnorm.NSWNormalizer(s).normalize() == \
            jnorm.NSWNormalizer(s).normalize()
        assert tnorm.normalize_zh_full(s) == jnorm.normalize_zh_full(s)
        assert ttp.normalize_zh(s) == jtp.normalize_zh(s)
    for num in ("0", "7", "10", "15", "101", "2000", "100000001",
                "3.1415", "0.05"):
        assert tnorm.num_to_hanzi(num) == jnorm.num_to_hanzi(num), num
        assert tnorm.num_to_hanzi(num, per_digit=True) == \
            jnorm.num_to_hanzi(num, per_digit=True)
    for han in ("一万零一", "两千", "十五", "三点一四"):
        assert tnorm.hanzi_to_num(han) == jnorm.hanzi_to_num(han), han


def test_zh_hanzi_without_pypinyin(monkeypatch):
    """Neither machine has pypinyin: the shipped table gives the pinyin,
    as JAX's does (``tests/test_text.py::test_zh_hanzi_without_pypinyin``);
    with pypinyin blocked explicitly too."""
    monkeypatch.setitem(sys.modules, "pypinyin", None)
    table = ttp._zh_pinyin_table()
    assert len(table) > 10000 and table == jtp._zh_pinyin_table()
    assert ttp.hanzi_text_to_pinyin("我爱你") == ["wo3", "ai4", "ni3"]
    phs, txt = ttp.get_txt_processor_cls("zh").process("月亮代表我的心")
    assert txt == "yue4 liang4 dai4 biao3 wo3 de5 xin1"
    assert (phs, txt) == jtp.get_txt_processor_cls("zh").process(
        "月亮代表我的心")


def test_assets_are_byte_equal_to_jax_and_used():
    ours = REPO / "stylesinger_torch" / "assets"
    ref = REPO / "stylesinger_tpu" / "assets"
    names = sorted(p.name for p in ref.iterdir())
    assert names == ["en_lexicon.txt", "en_lts.json", "zh_pinyin.json"]
    assert sorted(p.name for p in ours.iterdir()) == names
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
    assert Path(ttp._ASSETS).resolve() == ours.resolve()


def test_token_encoder_round_trips_as_jax(tmp_path):
    phones = ["x", "iao3", "|", "SP", "AP", "<BOS>", "ü", "b", "a"]
    ours, ref = ttext.TokenTextEncoder.build(phones), \
        jtext.TokenTextEncoder.build(phones)
    s = "x iao3 | SP zz ü a <BOS>"
    ids = ours.encode(s)
    assert ids == ref.encode(s) and ttext.UNK_ID in ids
    for kw in (dict(), dict(strip_eos=True), dict(strip_padding=True)):
        seq = ids + [ours.eos(), 5, ours.pad(), 6]
        assert ours.decode(seq, **kw) == ref.decode(seq, **kw)
    assert ours.decode_list(ids + [999]) == ref.decode_list(ids + [999])
    assert (ours.vocab_size, len(ours), ours.pad(), ours.eos(), ours.unk(),
            ours.seg_index) == (ref.vocab_size, len(ref), ref.pad(),
                                ref.eos(), ref.unk(), ref.seg_index)
    assert sorted(ours.sil_phonemes()) == sorted(ref.sil_phonemes())
    for name in ("phone_set.json", "vocab.txt"):
        ours.store_to_file(str(tmp_path / "ours" / name))
        ref.store_to_file(str(tmp_path / "ref" / name))
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
        back = ttext.TokenTextEncoder.from_file(str(tmp_path / "ours" / name))
        jback = jtext.TokenTextEncoder.from_file(str(tmp_path / "ref" / name))
        assert back.encode(s) == jback.encode(s) == ids
    for arg in (phones, str(tmp_path / "ours" / "phone_set.json")):
        assert ttext.build_token_encoder(arg).encode(s) == \
            jtext.build_token_encoder(arg).encode(s)
    vocab = ["a", "b", "<pad>", "<EOS>", "<UNK>"]
    plain = ttext.TokenTextEncoder(vocab, add_reserved=False,
                                   replace_oov=None)
    jplain = jtext.TokenTextEncoder(vocab, add_reserved=False,
                                    replace_oov=None)
    assert plain.encode("b a <UNK>") == jplain.encode("b a <UNK>") == [1, 0, 4]
    with pytest.raises(KeyError):
        plain.encode("zz")
