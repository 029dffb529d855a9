"""Text front-end: g2p processors + Chinese NSW normalization (a copy of
``stylesinger_tpu/text_processors.py``; the assets are the port's own copy
in ``stylesinger_torch/assets/``, byte for byte the JAX package's, and the
normalizer is the port's ``text_norm_zh``).

Parity targets (AaronZ345/StyleSinger):
- processor registry (``data_gen/tts/txt_processors/base_text_processor.py``)
- zh: pypinyin initials/finals + tone5 + rule-based normalizer
  (``txt_processors/zh.py:29-44``, ``utils/text_norm.py``).  Re-designed
  self-contained: a longest-prefix pinyin syllable splitter replaces
  pypinyin's initial/final tables (pypinyin itself is only needed for raw
  hanzi input and is loaded lazily when present);
- en: g2p_en (``txt_processors/en.py:44-80``); without the CMU dict in the
  image, the fallback is an embedded ~250-word high-frequency/irregular
  lexicon + a context-sensitive letter-to-sound rule engine (suffix,
  digraph, r-controlled, vowel-team, magic-e, soft-c/g rules → stressless
  ARPAbet); g2p_en is used when importable.
- zh_g2pM (``txt_processors/zh_g2pM.py``): per-character G2pM polyphone
  disambiguation + jieba word bounds when those packages are present;
  pinyin fallback keeps the ['|', '#'] separator contract.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple, Type

REGISTERED_TEXT_PROCESSORS: Dict[str, Type] = {}


def register_txt_processors(name: str):
    def wrap(cls):
        REGISTERED_TEXT_PROCESSORS[name] = cls
        return cls
    return wrap


def get_txt_processor_cls(name: str):
    return REGISTERED_TEXT_PROCESSORS[name]


class BaseTxtProcessor:
    @staticmethod
    def sp_phonemes() -> List[str]:
        return ["|"]

    @classmethod
    def process(cls, txt: str) -> Tuple[List[str], str]:
        """text -> (phoneme list, normalized text)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# zh: pinyin initial/final splitting (pypinyin-free for pinyin input)
# ---------------------------------------------------------------------------

# standard pinyin initials, longest first for prefix matching
_INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
             "g", "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w"]

def split_pinyin(syllable: str) -> List[str]:
    """'xiao' -> ['x', 'iao']; 'ang' -> ['ang']; keeps trailing tone digit
    on the final ('hao3' -> ['h', 'ao3'])."""
    s = syllable.strip().lower()
    if not s:
        return []
    for ini in _INITIALS:
        if s.startswith(ini) and len(s) > len(ini):
            return [ini, s[len(ini):]]
    return [s]


# full NSW engine (dates, money, phones, fractions, percent, digit
# strings — the reference's complete utils/text_norm.py rule set)
from stylesinger_torch.text_norm_zh import (  # noqa: E402
    NSWNormalizer, hanzi_to_num, num_to_hanzi,
)


def normalize_zh(text: str) -> str:
    """Full NSW normalization, punctuation preserved (the zh g2p pipeline
    strips it separately — reference txt_processors/zh.py:15-26)."""
    return NSWNormalizer(text).normalize(remove_punc=False)


_ZH_PINYIN: Optional[dict] = None


def _zh_pinyin_table() -> dict:
    """The shipped hanzi -> pinyin-TONE3 table (assets/zh_pinyin.json,
    13k+ chars; built by tools/build_zh_pinyin.py from authored seeds
    cross-validated against the CLDR pinyin collation data on-image).
    Makes raw-hanzi input work without pypinyin — the reference depends
    on pypinyin unconditionally (data_gen/tts/txt_processors/zh.py:1-10)."""
    global _ZH_PINYIN
    if _ZH_PINYIN is None:
        path = os.path.join(_ASSETS, "zh_pinyin.json")
        _ZH_PINYIN = json.load(open(path, encoding="utf-8")) \
            if os.path.exists(path) else {}
    return _ZH_PINYIN


def hanzi_text_to_pinyin(txt: str) -> List[str]:
    """Per-char most-common-reading conversion via the shipped table;
    non-hanzi runs pass through as their own tokens. Unknown hanzi fall
    back to an 'SP' placeholder rather than crashing the pipeline."""
    table = _zh_pinyin_table()
    out: List[str] = []
    pending = ""
    for ch in txt:
        if re.match(r"[一-鿿]", ch):
            if pending.strip():
                out.extend(pending.split())
            pending = ""
            out.append(table.get(ch, "SP"))
        else:
            pending += ch
    if pending.strip():
        out.extend(pending.split())
    return out


@register_txt_processors("zh")
class ZhTxtProcessor(BaseTxtProcessor):
    """Accepts space-separated pinyin directly; raw hanzi goes through
    pypinyin when available, else the shipped zh_pinyin table."""

    @classmethod
    def process(cls, txt: str) -> Tuple[List[str], str]:
        txt = normalize_zh(txt.strip())
        if re.search(r"[一-鿿]", txt):
            try:
                from pypinyin import Style, pinyin  # type: ignore
                sylls = [p[0] for p in pinyin(txt, style=Style.TONE3,
                                              neutral_tone_with_five=True)]
            except ImportError:
                sylls = hanzi_text_to_pinyin(txt)
            txt = " ".join(sylls)
        phs: List[str] = []
        for syll in txt.split():
            if syll in ("AP", "SP", "|", "<AP>", "<SP>"):
                phs.append(syll)
                continue
            phs.extend(split_pinyin(syll))
        return phs, txt


# ---------------------------------------------------------------------------
# en: embedded lexicon + context-sensitive letter-to-sound rules
# ---------------------------------------------------------------------------

# high-frequency + irregular words with CMU-style ARPAbet (stressless):
# lexicon hit -> exact pronunciation; everything else goes to the rules
_EN_LEXICON = {
    "the": "DH AH", "a": "AH", "an": "AE N", "and": "AE N D",
    "of": "AH V", "to": "T UW", "in": "IH N", "is": "IH Z",
    "you": "Y UW", "that": "DH AE T", "it": "IH T", "he": "HH IY",
    "she": "SH IY", "was": "W AA Z", "for": "F AO R", "on": "AA N",
    "are": "AA R", "as": "AE Z", "with": "W IH DH", "his": "HH IH Z",
    "her": "HH ER", "they": "DH EY", "i": "AY", "at": "AE T",
    "be": "B IY", "this": "DH IH S", "have": "HH AE V",
    "from": "F R AH M", "or": "AO R", "one": "W AH N", "had": "HH AE D",
    "by": "B AY", "word": "W ER D", "but": "B AH T", "not": "N AA T",
    "what": "W AH T", "all": "AO L", "were": "W ER", "we": "W IY",
    "when": "W EH N", "your": "Y AO R", "can": "K AE N",
    "said": "S EH D", "there": "DH EH R", "use": "Y UW Z",
    "each": "IY CH", "which": "W IH CH", "do": "D UW",
    "how": "HH AW", "their": "DH EH R", "if": "IH F",
    "will": "W IH L", "up": "AH P", "other": "AH DH ER",
    "about": "AH B AW T", "out": "AW T", "many": "M EH N IY",
    "then": "DH EH N", "them": "DH EH M", "these": "DH IY Z",
    "so": "S OW", "some": "S AH M", "would": "W UH D",
    "make": "M EY K", "like": "L AY K", "him": "HH IH M",
    "into": "IH N T UW", "time": "T AY M", "has": "HH AE Z",
    "look": "L UH K", "two": "T UW", "more": "M AO R",
    "write": "R AY T", "go": "G OW", "see": "S IY",
    "no": "N OW", "way": "W EY", "could": "K UH D",
    "people": "P IY P AH L", "my": "M AY", "than": "DH AE N",
    "first": "F ER S T", "water": "W AO T ER", "been": "B IH N",
    "who": "HH UW", "oil": "OY L", "its": "IH T S",
    "now": "N AW", "find": "F AY N D", "long": "L AO NG",
    "down": "D AW N", "day": "D EY", "did": "D IH D",
    "get": "G EH T", "come": "K AH M", "made": "M EY D",
    "may": "M EY", "part": "P AA R T", "over": "OW V ER",
    "new": "N UW", "sound": "S AW N D", "take": "T EY K",
    "only": "OW N L IY", "little": "L IH T AH L", "work": "W ER K",
    "know": "N OW", "place": "P L EY S", "year": "Y IH R",
    "live": "L IH V", "me": "M IY", "back": "B AE K",
    "give": "G IH V", "most": "M OW S T", "very": "V EH R IY",
    "after": "AE F T ER", "thing": "TH IH NG", "our": "AW ER",
    "just": "JH AH S T", "name": "N EY M", "good": "G UH D",
    "sentence": "S EH N T AH N S", "man": "M AE N",
    "think": "TH IH NG K", "say": "S EY", "great": "G R EY T",
    "where": "W EH R", "help": "HH EH L P", "through": "TH R UW",
    "much": "M AH CH", "before": "B IH F AO R", "line": "L AY N",
    "right": "R AY T", "too": "T UW", "mean": "M IY N",
    "old": "OW L D", "any": "EH N IY", "same": "S EY M",
    "tell": "T EH L", "boy": "B OY", "follow": "F AA L OW",
    "came": "K EY M", "want": "W AA N T", "show": "SH OW",
    "also": "AO L S OW", "around": "ER AW N D", "form": "F AO R M",
    "three": "TH R IY", "small": "S M AO L", "set": "S EH T",
    "put": "P UH T", "end": "EH N D", "does": "D AH Z",
    "another": "AH N AH DH ER", "well": "W EH L", "large": "L AA R JH",
    "must": "M AH S T", "big": "B IH G", "even": "IY V AH N",
    "such": "S AH CH", "because": "B IH K AO Z", "turn": "T ER N",
    "here": "HH IY R", "why": "W AY", "ask": "AE S K",
    "went": "W EH N T", "men": "M EH N", "read": "R IY D",
    "need": "N IY D", "land": "L AE N D", "different": "D IH F ER AH N T",
    "home": "HH OW M", "us": "AH S", "move": "M UW V",
    "try": "T R AY", "kind": "K AY N D", "hand": "HH AE N D",
    "picture": "P IH K CH ER", "again": "AH G EH N",
    "change": "CH EY N JH", "off": "AO F", "play": "P L EY",
    "spell": "S P EH L", "air": "EH R", "away": "AH W EY",
    "animal": "AE N AH M AH L", "house": "HH AW S",
    "point": "P OY N T", "page": "P EY JH", "letter": "L EH T ER",
    "mother": "M AH DH ER", "answer": "AE N S ER",
    "found": "F AW N D", "study": "S T AH D IY", "still": "S T IH L",
    "learn": "L ER N", "should": "SH UH D", "world": "W ER L D",
    "high": "HH AY", "every": "EH V ER IY", "near": "N IH R",
    "add": "AE D", "food": "F UW D", "between": "B IH T W IY N",
    "own": "OW N", "below": "B IH L OW", "country": "K AH N T R IY",
    "plant": "P L AE N T", "last": "L AE S T", "school": "S K UW L",
    "father": "F AA DH ER", "keep": "K IY P", "tree": "T R IY",
    "never": "N EH V ER", "start": "S T AA R T", "city": "S IH T IY",
    "earth": "ER TH", "eye": "AY", "light": "L AY T",
    "thought": "TH AO T", "head": "HH EH D", "under": "AH N D ER",
    "story": "S T AO R IY", "saw": "S AO", "left": "L EH F T",
    "don't": "D OW N T", "few": "F Y UW", "while": "W AY L",
    "along": "AH L AO NG", "might": "M AY T", "close": "K L OW S",
    "something": "S AH M TH IH NG", "seem": "S IY M",
    "next": "N EH K S T", "hard": "HH AA R D", "open": "OW P AH N",
    "example": "IH G Z AE M P AH L", "begin": "B IH G IH N",
    "life": "L AY F", "always": "AO L W EY Z", "those": "DH OW Z",
    "both": "B OW TH", "paper": "P EY P ER",
    "together": "T AH G EH DH ER", "got": "G AA T",
    "group": "G R UW P", "often": "AO F AH N", "run": "R AH N",
    "important": "IH M P AO R T AH N T", "until": "AH N T IH L",
    "children": "CH IH L D R AH N", "side": "S AY D",
    "feet": "F IY T", "car": "K AA R", "mile": "M AY L",
    "night": "N AY T", "walk": "W AO K", "white": "W AY T",
    "sea": "S IY", "began": "B IH G AE N", "grow": "G R OW",
    "took": "T UH K", "river": "R IH V ER", "four": "F AO R",
    "carry": "K AE R IY", "state": "S T EY T", "once": "W AH N S",
    "book": "B UH K", "hear": "HH IY R", "stop": "S T AA P",
    "without": "W IH TH AW T", "second": "S EH K AH N D",
    "love": "L AH V", "heart": "HH AA R T", "hello": "HH AH L OW",
    "world's": "W ER L D Z", "music": "M Y UW Z IH K",
    "song": "S AO NG", "sing": "S IH NG", "voice": "V OY S",
    "beautiful": "B Y UW T AH F AH L", "one's": "W AH N Z",
}

# ordered context-sensitive LTS rules: (pattern, phones, advance).
# pattern is matched at the cursor; "$" = end of word, "^" = start,
# "V" = any vowel letter at that position, "C" = any consonant
_EN_RULES: List[Tuple[str, str, int]] = [
    # suffixes / endings
    ("tion$", "SH AH N", 4), ("sion$", "ZH AH N", 4),
    ("tious$", "SH AH S", 5), ("cious$", "SH AH S", 5),
    ("ture$", "CH ER", 4), ("sure$", "ZH ER", 4),
    ("ought$", "AO T", 5), ("aught$", "AO T", 5),
    ("ing$", "IH NG", 3), ("ings$", "IH NG Z", 4),
    ("able$", "AH B AH L", 4), ("ible$", "AH B AH L", 4),
    ("ally$", "AH L IY", 4), ("ily$", "AH L IY", 3),
    ("ly$", "L IY", 2), ("ies$", "IY Z", 3), ("ied$", "IY D", 3),
    ("es$", "IH Z", 2), ("ed$", "D", 2), ("y$", "IY", 1),
    ("le$", "AH L", 2), ("ey$", "IY", 2),
    # silent letters / clusters
    ("^kn", "N", 2), ("^wr", "R", 2), ("^ps", "S", 2), ("^gn", "N", 2),
    ("mb$", "M", 2), ("igh", "AY", 3), ("eigh", "EY", 4),
    ("tch", "CH", 3), ("dge", "JH", 3), ("ck", "K", 2),
    # consonant digraphs
    ("ch", "CH", 2), ("sh", "SH", 2), ("th", "TH", 2), ("ph", "F", 2),
    ("gh", "G", 2), ("wh", "W", 2), ("ng", "NG", 2), ("qu", "K W", 2),
    # r-controlled vowels
    ("ar", "AA R", 2), ("or", "AO R", 2), ("er", "ER", 2),
    ("ir", "ER", 2), ("ur", "ER", 2), ("ear", "IH R", 3),
    # vowel teams
    ("ai", "EY", 2), ("ay", "EY", 2), ("ee", "IY", 2), ("ea", "IY", 2),
    ("oa", "OW", 2), ("oo", "UW", 2), ("ou", "AW", 2), ("ow", "OW", 2),
    ("oi", "OY", 2), ("oy", "OY", 2), ("au", "AO", 2), ("aw", "AO", 2),
    ("ue", "UW", 2), ("ui", "UW", 2), ("ew", "UW", 2), ("ie", "IY", 2),
    # magic-e long vowels (aCe / iCe / oCe / uCe)
    ("aCe$", "EY", -1), ("iCe$", "AY", -1), ("oCe$", "OW", -1),
    ("uCe$", "UW", -1), ("eCe$", "IY", -1),
    # soft c / g
    ("ce", "S", 1), ("ci", "S", 1), ("cy", "S", 1),
    ("ge", "JH", 1), ("gi", "JH", 1), ("gy", "JH", 1),
    # single letters
    ("a", "AE", 1), ("b", "B", 1), ("c", "K", 1), ("d", "D", 1),
    ("e", "EH", 1), ("f", "F", 1), ("g", "G", 1), ("h", "HH", 1),
    ("i", "IH", 1), ("j", "JH", 1), ("k", "K", 1), ("l", "L", 1),
    ("m", "M", 1), ("n", "N", 1), ("o", "AA", 1), ("p", "P", 1),
    ("q", "K", 1), ("r", "R", 1), ("s", "S", 1), ("t", "T", 1),
    ("u", "AH", 1), ("v", "V", 1), ("w", "W", 1), ("x", "K S", 1),
    ("y", "Y", 1), ("z", "Z", 1),
]

_EN_VOWELS = set("aeiou")


def _match_rule(w: str, i: int, pat: str) -> int:
    """Length of the literal consumed match at w[i:] or -1. Handles the
    ^/$ anchors and the magic-e VCe template (consumes vowel+consonant,
    leaving the final silent e to be skipped)."""
    p = pat
    if p.startswith("^"):
        if i != 0:
            return -1
        p = p[1:]
    anchored_end = p.endswith("$")
    if anchored_end:
        p = p[:-1]
    if "C" in p:  # magic-e template: vowel, any consonant, silent e
        v, _, _ = p[0], p[1], p[2]
        if (i + 3 == len(w) and w[i] == v and
                w[i + 1] not in _EN_VOWELS and w[i + 1].isalpha() and
                w[i + 2] == "e"):
            return 2   # consume vowel+consonant; trailing e dropped later
        return -1
    if not w.startswith(p, i):
        return -1
    if anchored_end and i + len(p) != len(w):
        return -1
    return len(p)


_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
_FULL_EN_LEXICON: Optional[dict] = None
_LTS_MODEL: Optional["LtsModel"] = None


def full_en_lexicon() -> dict:
    """The embedded high-frequency table merged with the large shipped
    lexicon (assets/en_lexicon.txt, CMU ``word  PH PH ...`` lines) —
    lazily loaded and cached."""
    global _FULL_EN_LEXICON
    if _FULL_EN_LEXICON is None:
        lex = dict(_EN_LEXICON)
        path = os.path.join(_ASSETS, "en_lexicon.txt")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith(";"):
                        continue
                    parts = line.split()
                    lex[parts[0].lower()] = " ".join(parts[1:])
        _FULL_EN_LEXICON = lex
    return _FULL_EN_LEXICON


class LtsModel:
    """Runtime decoder for the trained joint-sequence LTS
    (tools/train_en_lts.py): beam search over graphone segmentations
    scored by a Witten-Bell-interpolated graphone n-gram."""

    def __init__(self, model: dict):
        self.order = model["order"]
        self.vocab: List[Tuple[str, Tuple[str, ...]]] = []
        for key in model["vocab"]:
            letters, _, phones = key.partition("|")
            self.vocab.append((letters, tuple(phones.split())))
        self.eos = next(i for i, (l, p) in enumerate(self.vocab)
                        if l == "</s>")
        # letters -> candidate graphone ids
        self.by_letters: dict = {}
        for i, (letters, _) in enumerate(self.vocab):
            if letters != "</s>":
                self.by_letters.setdefault(letters, []).append(i)
        # counts[n][(ctx_key, tok_id)] and ctx totals / distinct counts
        self.counts = []
        self.ctx_tot = []
        self.ctx_distinct = []
        for n in range(self.order):
            tab = {}
            distinct = {}
            for ctx_key, rows in model["counts"][n].items():
                for tok, c in rows:
                    tab[(ctx_key, tok)] = c
                distinct[ctx_key] = len(rows)
            self.counts.append(tab)
            self.ctx_distinct.append(distinct)
            self.ctx_tot.append({k: float(v) for k, v in
                                 model["ctx_counts"][n].items()})
        self.v = len(self.vocab)

    def _logp(self, hist: Tuple[int, ...], tok: int) -> float:
        p = 1.0 / max(self.v, 1)
        for n in range(1, self.order + 1):
            ctx = hist[len(hist) - n + 1:] if n > 1 else ()
            key = ",".join(str(t) for t in ctx)
            N = self.ctx_tot[n - 1].get(key, 0.0)
            if N <= 0:
                continue
            T = self.ctx_distinct[n - 1].get(key, 0)
            lam = N / (N + T) if (N + T) > 0 else 0.0
            c = self.counts[n - 1].get((key, tok), 0.0)
            p = lam * (c / N) + (1.0 - lam) * p
        return math.log(max(p, 1e-12))

    def decode(self, word: str, beam: int = 8) -> List[str]:
        word = word.lower()
        W = len(word)
        # beams: (pos, hist) -> (score, phones)
        bos = (-1,) * (self.order - 1)
        beams = {(0, bos): (0.0, ())}
        for _ in range(2 * W + 2):
            nxt: dict = {}
            done = True
            for (pos, hist), (score, phones) in beams.items():
                if pos == W:
                    if (pos, hist) not in nxt or \
                            nxt[(pos, hist)][0] < score:
                        nxt[(pos, hist)] = (score, phones)
                    continue
                done = False
                any_cand = False
                for dl in (1, 2):
                    cand = self.by_letters.get(word[pos:pos + dl])
                    if not cand:
                        continue
                    any_cand = True
                    for gi in cand:
                        s = score + self._logp(hist, gi)
                        h2 = (hist + (gi,))[-(self.order - 1):]
                        k = (pos + dl, h2)
                        ph2 = phones + self.vocab[gi][1]
                        if k not in nxt or nxt[k][0] < s:
                            nxt[k] = (s, ph2)
                if not any_cand:
                    # letter unseen in training: skip it at a fixed
                    # penalty so rare words still decode end-to-end
                    k = (pos + 1, hist)
                    if k not in nxt or nxt[k][0] < score - 10.0:
                        nxt[k] = (score - 10.0, phones)
            beams = dict(sorted(nxt.items(), key=lambda kv: -kv[1][0])
                         [:beam])
            if done:
                break
        best, best_ph = -1e30, ()
        for (pos, hist), (score, phones) in beams.items():
            if pos != W:
                continue
            s = score + self._logp(hist, self.eos)
            if s > best:
                best, best_ph = s, phones
        return list(best_ph)


def _lts_model() -> Optional["LtsModel"]:
    """The shipped trained LTS (assets/en_lts.json), lazily loaded."""
    global _LTS_MODEL
    if _LTS_MODEL is None:
        path = os.path.join(_ASSETS, "en_lts.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            _LTS_MODEL = LtsModel(json.load(f))
    return _LTS_MODEL


_MORPH_SUFFIXES: List[Tuple[str, str, str]] = [
    # (suffix, phones appended, stem transform): longest first
    ("ingly", "IH NG L IY", ""), ("edly", "IH D L IY", ""),
    ("ings", "IH NG Z", ""), ("ing", "IH NG", ""),
    ("ednesses", "", None), ("ness", "N AH S", ""),
    ("ments", "M AH N T S", ""), ("ment", "M AH N T", ""),
    ("fully", "F UH L IY", ""), ("ful", "F AH L", ""),
    ("less", "L AH S", ""), ("ly", "L IY", ""),
    ("ers", "ER Z", ""), ("er", "ER", ""), ("est", "AH S T", ""),
]


def _voiced_final(phones: List[str]) -> bool:
    return bool(phones) and phones[-1] not in {
        "P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}


def _morph_lookup(w: str, lex: dict) -> Optional[List[str]]:
    """Regular inflections of lexicon stems: -s/-es/-ed/-ing/-er/... with
    CMU-consistent voicing ('dogs' -> D AO G Z, 'cats' -> K AE T S,
    'wanted' -> ... IH D). Doubles effective lexicon coverage without
    doubling the table."""
    # plural / 3sg / possessive
    for suf in ("'s", "s'", "s", "es"):
        if w.endswith(suf) and len(w) > len(suf) + 1:
            stem = w[: len(w) - len(suf)]
            base = lex.get(stem)
            if suf == "es" and base is None:
                base = lex.get(stem + "e")
            if base:
                ph = base.split()
                if ph[-1] in {"S", "Z", "SH", "ZH", "CH", "JH"}:
                    return ph + ["IH", "Z"]
                return ph + (["Z"] if _voiced_final(ph) else ["S"])
    # past tense ("walked" -> walk, "loved" -> love, "stopped" -> stop)
    if w.endswith("ed") and len(w) > 3:
        stems = [w[:-2], w[:-1]]
        if len(w) > 4 and w[-3] == w[-4]:
            stems.append(w[:-3])
        for stem in stems:
            base = lex.get(stem)
            if base:
                ph = base.split()
                if ph[-1] in {"T", "D"}:
                    return ph + ["IH", "D"]
                return ph + (["D"] if _voiced_final(ph) else ["T"])
    # other regular suffixes ("walking" -> walk, "loving" -> love,
    # "running" -> run via consonant undoubling)
    for suf, phones, _ in _MORPH_SUFFIXES:
        if phones and w.endswith(suf) and len(w) > len(suf) + 2:
            s = w[: len(w) - len(suf)]
            stems = [s, s + "e"]
            if len(s) > 2 and s[-1] == s[-2]:
                stems.append(s[:-1])
            for stem in stems:
                base = lex.get(stem)
                if base:
                    return base.split() + phones.split()
    return None


def _letter_to_sound(word: str) -> List[str]:
    """English g2p (ARPAbet, stressless): shipped lexicon -> regular
    morphology over lexicon stems -> trained joint-sequence LTS
    (assets/en_lts.json) -> rule table as the last-ditch fallback.
    Reference counterpart: g2p_en = CMUdict + neural LTS
    (data_gen/tts/txt_processors/en.py:44-80)."""
    w = word.lower()
    lex = full_en_lexicon()
    if w in lex:
        return lex[w].split()
    morph = _morph_lookup(w, lex)
    if morph is not None:
        return morph
    # closed compounds of two known words ("moonlit", "heartbreak") —
    # prefer the split with the longer first element
    if len(w) >= 6 and w.isalpha():
        for i in range(len(w) - 2, 2, -1):
            a, b = w[:i], w[i:]
            pa = lex.get(a)
            pb = lex.get(b) or (" ".join(_morph_lookup(b, lex) or [])
                                or None)
            if pa and pb:
                return pa.split() + pb.split()
    lts = _lts_model()
    if lts is not None and w.isalpha():
        out = lts.decode(w)
        if out:
            return out
    return _letter_to_sound_rules(w)


def _letter_to_sound_rules(word: str) -> List[str]:
    """Rule-based English LTS fallback (ARPAbet, stressless)."""
    w = word.lower()
    phs: List[str] = []
    i = 0
    while i < len(w):
        if not w[i].isalpha():
            i += 1
            continue
        for pat, phones, adv in _EN_RULES:
            n = _match_rule(w, i, pat)
            if n < 0:
                continue
            phs.extend(phones.split())
            if adv == -1:      # magic-e: vowel+consonant consumed, the
                i += 1         # consonant reads by its own rule next
            else:
                i += n
            break
        else:
            i += 1
        # skip a silent final e
        if i == len(w) - 1 and w[i] == "e" and len(w) > 2 and phs:
            break
    return phs


@register_txt_processors("en")
class EnTxtProcessor(BaseTxtProcessor):
    @classmethod
    def process(cls, txt: str) -> Tuple[List[str], str]:
        txt = re.sub(r"[^ a-zA-Z'.,?!\-]", "", txt.strip()).lower()
        try:
            from g2p_en import G2p  # type: ignore
            g2p = G2p()
            phs = [p for p in g2p(txt) if p.strip()]
        except ImportError:
            phs = []
            for word in txt.split():
                word = word.strip(".,?!-'")
                if word:
                    phs.extend(_letter_to_sound(word))
                    phs.append("|")
            if phs and phs[-1] == "|":
                phs.pop()
        return phs, txt


# ---------------------------------------------------------------------------
# zh_g2pM: per-character g2p with polyphone disambiguation + word bounds
# ---------------------------------------------------------------------------

_PUNCS = "!,.?;:"

# fullwidth -> halfwidth (reference txt_processors/zh.py:10-12)
_FULLWIDTH_TABLE = {ord(f): ord(t) for f, t in zip(
    "：，。！？【】（）％＃＠＆１２３４５６７８９０",
    ":,.!?[]()%#@&1234567890")}


def preprocess_text_zh(text: str) -> str:
    """The reference zh preprocessing chain minus per-char spacing
    (``zh.TxtProcessor.preprocess_text``, txt_processors/zh.py:14-26):
    fullwidth translation -> NSW normalize -> strip quotes/parens ->
    keep only letters/hanzi/PUNCS -> collapse+space punctuation."""
    text = text.translate(_FULLWIDTH_TABLE)
    text = normalize_zh(text)
    text = re.sub(r"['\"()]+", "", text)
    text = re.sub(r"[-]+", " ", text)
    text = re.sub(f"[^ A-Za-z一-鿿{_PUNCS}]", "", text)
    text = re.sub(f"([{_PUNCS}])+", r"\1", text)
    text = re.sub(f"([{_PUNCS}])", r" \1 ", text)
    text = re.sub(r"\s+", "", text)
    return text


def _hanzi_to_pinyin(p: str, use_tone: bool = True) -> str:
    """Re-convert a still-hanzi G2pM output via pypinyin with neutral-tone
    '5' padding (reference zh_g2pM.py:43-49). Returns ``p`` unchanged when
    it is not hanzi or pypinyin is unavailable."""
    if not re.findall(r"[一-鿿]", p):
        return p
    try:
        from pypinyin import Style, pinyin  # type: ignore
    except ImportError:
        got = _zh_pinyin_table().get(p[0])
        if got is None:
            return p
        return got if use_tone else got.rstrip("12345")
    if use_tone:
        p = pinyin(p, style=Style.TONE3, strict=True)[0][0]
        if p[-1] not in "12345":
            p = p + "5"
    else:
        p = pinyin(p, style=Style.NORMAL, strict=True)[0][0]
    return p


@register_txt_processors("zh_g2pM")
class ZhG2pMTxtProcessor(BaseTxtProcessor):
    """Reference variant ``txt_processors/zh_g2pM.py``: G2pM neural
    polyphone disambiguation per hanzi + jieba word segmentation, '#'
    word-boundary tokens, shengmu/yunmu split, and silence-adjacent
    boundary cleanup.

    Those two packages aren't in this image, so: with g2pM+jieba
    importable the full reference behavior runs; otherwise pinyin input
    is processed directly with '#' boundaries taken from whitespace (one
    word per syllable group), keeping the token contract (['|', '#']
    separators) identical."""

    @staticmethod
    def sp_phonemes() -> List[str]:
        return ["|", "#"]

    @classmethod
    def _split_syllable(cls, p: str) -> List[str]:
        p = p.replace("u:", "v")
        return split_pinyin(p)

    @classmethod
    def _cleanup_boundaries(cls, phs: List[str]) -> List[str]:
        """Drop '#' word bounds adjacent to silence tokens (reference
        zh_g2pM.py:60-66)."""
        sil = set(_PUNCS) | set(cls.sp_phonemes())
        out: List[str] = []
        for i, p in enumerate(phs):
            prv = phs[i - 1] if i > 0 else ""
            nxt = phs[i + 1] if i + 1 < len(phs) else ""
            if p == "#" and (prv in sil or nxt in sil):
                continue
            out.append(p)
        return out

    @classmethod
    def process(cls, txt: str, use_tone: bool = True
                ) -> Tuple[List[str], str]:
        has_hanzi = re.search(r"[一-鿿]", txt) is not None
        if has_hanzi:
            # the full reference chain (zh_g2pM.py:26-49): preprocess
            # (fullwidth/punc/NSW), G2pM char-split, jieba '#' bounds,
            # pypinyin re-conversion of any output G2pM left as hanzi
            txt = preprocess_text_zh(txt.strip())
            try:
                import jieba  # type: ignore
                from g2pM import G2pM  # type: ignore
            except ImportError:
                raise RuntimeError(
                    "zh_g2pM with raw hanzi needs g2pM + jieba; pass "
                    "space-separated pinyin (words split by '#') instead")
            model = G2pM()
            sylls = model(txt, tone=use_tone, char_split=True)
            seg = "#".join(jieba.cut(txt))
            phs: List[str] = []
            si = 0
            for p in sylls:
                phs.append("#" if seg[si] == "#" else "|")
                if seg[si] == "#":
                    si += 1
                si += 1
                p = _hanzi_to_pinyin(p, use_tone)
                if p in _PUNCS:
                    phs.append(p)  # kept verbatim (reference :56-58)
                    continue
                phs.extend(cls._split_syllable(p))
            return cls._cleanup_boundaries(phs), txt
        txt = normalize_zh(txt.strip())
        # pinyin fallback: '#' separates words, whitespace separates
        # syllables; exactly ONE separator precedes each syllable ('#' at
        # a word start, '|' inside a word) as in the reference loop
        phs = []
        first_word = True
        for word in txt.split("#"):
            sylls = word.split()
            for wi, syll in enumerate(sylls):
                if syll in ("AP", "SP", "|", "<AP>", "<SP>"):
                    phs.append(syll)
                    continue
                phs.append("#" if (wi == 0 and not first_word) else "|")
                phs.extend(cls._split_syllable(syll))
            if sylls:
                first_word = False
        return cls._cleanup_boundaries(phs), txt
