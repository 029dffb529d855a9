"""Full Chinese non-standard-word (NSW) normalization (a copy of
``stylesinger_tpu/text_norm_zh.py``).

Behavioral parity target: ``utils/text_norm.py`` (790 LoC) in
AaronZ345/StyleSinger — the complete rule set, in the reference's
application order: dates, money amounts, mobile + landline phone numbers,
fractions, percentages, quantified counts, long digit strings, remaining
cardinals, the ``<letter>二<letter>`` → ``<letter>2<letter>`` fixup, and
punctuation removal.  Number reading uses the 'mid' Chinese numbering
system (万-grouped; 亿 = 10^8, 兆 = 10^12, ... — reference
``create_system``, text_norm.py:191-230) in both directions, including
the 两-substitution and leading 一十 elision rules.

Equivalence is proven table-driven against the *actual* reference module
in tests/test_text.py::test_nsw_normalizer_matches_reference (the
reference file is dependency-free, so tests import it directly).

The regex patterns and the Chinese unit/quantifier alphabets are shared
vocabulary with the reference — they ARE the spec (like the yaml
hyperparameter tables); the number engine and rule plumbing are
re-implemented.
"""

from __future__ import annotations

import re
import string
from typing import List, Optional, Tuple

DIGITS = "零一二三四五六七八九"
POINT = "点"
LIANG = "两"

# 'mid' numbering system: 十/百/千/万 small units, then 万^k group units
# (reference text_norm.py:96-104: larger-unit power = (index + 2) * 4)
UNIT_POWERS: List[Tuple[int, str]] = (
    [(1, "十"), (2, "百"), (3, "千"), (4, "万")] +
    [((i + 2) * 4, u) for i, u in enumerate("亿兆京垓秭穰沟涧正载")])
_UNIT_NAME = {p: u for p, u in UNIT_POWERS}
_UNIT_POWER = {u: p for p, u in UNIT_POWERS}
# traditional spellings accepted on the reading side
for _t, _s in zip("拾佰仟萬億", "十百千万亿"):
    _UNIT_POWER[_t] = _UNIT_POWER[_s]

_DIGIT_VALUE = {c: i for i, c in enumerate(DIGITS)}
_DIGIT_VALUE.update({"〇": 0, "幺": 1, "两": 2, "兩": 2})
_DIGIT_VALUE.update({c: i for i, c in enumerate("零壹贰叁肆伍陆柒捌玖")})
_DIGIT_VALUE.update({c: i for i, c in enumerate("零壹貳參肆伍陸柒捌玖")})

# linguistic data shared with the reference (text_norm.py:38-47)
CURRENCY_UNITS = ("((亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|)元|"
                  "(亿|千万|百万|万|千|百|)块|角|毛|分)")
COM_QUANTIFIERS = (
    "(匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|"
    "壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|"
    "队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|"
    "家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|毫|厘|"
    "分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|撮|勺|合|升|斗|石|盘|"
    "碗|碟|叠|桶|笼|盆|盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|"
    "啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|纪|岁|世|更|夜|春|夏|秋|冬|"
    "代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块)")
CHINESE_PUNC = ("！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀"
                "｛｜｝～｟｠｢｣､、〃《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞"
                "〟〰〾〿–—‘’‛“”„‟…‧﹏")


# ---------------------------------------------------------------------------
# number engine: digit string <-> hanzi
# ---------------------------------------------------------------------------

_Tok = Tuple[str, int]           # ("d", value) | ("u", power) | ("p", 0)


def _int_tokens(value_str: str) -> List[_Tok]:
    """Recursive unit decomposition of an integer digit string (the
    reference's ``get_value``): split at the largest unit whose power is
    smaller than the significant length, keeping interior zeros as a
    single 零 marker."""
    stripped = value_str.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        head: List[_Tok] = [("d", 0)] if len(value_str) != len(stripped) \
            else []
        return head + [("d", int(stripped))]
    power = max(p for p, _ in UNIT_POWERS if p < len(stripped))
    return (_int_tokens(value_str[:-power]) + [("u", power)] +
            _int_tokens(stripped[-power:]))


def num_to_hanzi(num: str, *, per_digit: bool = False,
                 use_liang: bool = True) -> str:
    """'12005.4' -> 一万两千零五点四; per_digit reads digit-wise
    ('2024' -> 二零二四, the Digit/TelePhone classes' mode)."""
    num = num.strip()
    int_str, _, dec_str = num.partition(".")
    if per_digit or len(int_str) <= 1:
        toks: List[_Tok] = [("d", int(c)) for c in int_str]
    else:
        toks = _int_tokens(int_str)
    if dec_str:
        toks += [("p", 0)] + [("d", int(c)) for c in dec_str]

    if use_liang and not per_digit:
        # 2 reads 两 before a non-十 unit unless preceded by a 十 unit
        # (reference num2chn alt_two block)
        for i, (kind, val) in enumerate(toks):
            if kind != "d" or val != 2:
                continue
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            prv = toks[i - 1] if i > 0 else None
            if (nxt is not None and nxt[0] == "u" and nxt[1] != 1 and
                    (prv is None or (prv[0] == "u" and prv[1] != 1))):
                toks[i] = ("l", 2)

    out = "".join(LIANG if k == "l" else POINT if k == "p"
                  else DIGITS[v] if k == "d" else _UNIT_NAME[v]
                  for k, v in toks)
    if out.startswith(POINT):
        out = DIGITS[0] + out
    if len(out) >= 2 and out[0] == DIGITS[1] and out[1] == "十":
        out = out[1:]                      # 一十X -> 十X
    return out


def hanzi_to_num(text: str) -> str:
    """Chinese number reading -> digit string ('三千五百万' -> '35000000',
    '十二点五' -> '12.5'); the reverse direction (reference ``chn2num``)."""
    int_text, sep, dec_text = text.partition(POINT)
    if not sep:  # traditional spelling
        int_text, sep, dec_text = text.partition("點")

    toks: List[_Tok] = []
    for ch in int_text:
        if ch in _DIGIT_VALUE:
            toks.append(("d", _DIGIT_VALUE[ch]))
        elif ch in _UNIT_POWER:
            toks.append(("u", _UNIT_POWER[ch]))
    # leading bare 十 -> 一十
    if toks and toks[0][0] == "u" and toks[0][1] == 1:
        toks.insert(0, ("d", 1))
    # trailing digit inherits the previous unit minus one: 一百八 -> 180
    if len(toks) > 1 and toks[-1][0] == "d" and toks[-2][0] == "u":
        toks.append(("u", toks[-2][1] - 1))
    # consecutive units compound: 三千万 -> the 千 carries the 万's power
    # (reference correct_symbols unit_count branch)
    merged: List[_Tok] = []
    run = 0
    for kind, val in toks:
        if kind == "d":
            merged.append((kind, val))
            run = 0
            continue
        run += 1
        if run == 1:
            merged.append((kind, val))
        else:
            for j in range(len(merged) - 1, -1, -1):
                if merged[j][0] == "u" and merged[j][1] < val:
                    merged[j] = ("u", merged[j][1] + val)

    # evaluate (reference compute_value): a unit larger than any seen so
    # far multiplies everything accumulated before it (两千万 = 2000*1e4)
    sections: List[int] = [0]
    top_power = 0
    for kind, val in merged:
        if kind == "d":
            sections[-1] = val
        else:
            sections[-1] *= 10 ** val
            if val > top_power:
                sections[:-1] = [s * 10 ** val for s in sections[:-1]]
                top_power = val
            sections.append(0)
    int_out = str(sum(sections))

    dec_digits = "".join(str(_DIGIT_VALUE[c]) for c in dec_text
                         if c in _DIGIT_VALUE)
    return f"{int_out}.{dec_digits}" if dec_digits else int_out


# ---------------------------------------------------------------------------
# NSW rewriters (reference rule classes, text_norm.py:419-601)
# ---------------------------------------------------------------------------

def read_date(date: str) -> str:
    """'2024年3月5日' -> 二零二四年三月五日 (year digit-wise, month/day
    cardinal; reference Date.date2chntext)."""
    year = ""
    rest = date
    if "年" in date:
        y, rest = date.strip().split("年", 1)
        year = num_to_hanzi(y, per_digit=True, use_liang=False) + "年"
    month = day = ""
    if rest:
        if "月" in rest:
            m, day = rest.strip().split("月", 1)
            month = num_to_hanzi(m) + "月"
        else:
            # unreachable from normalize() (the date regex only admits a
            # day after 月); the reference's equivalent branch re-reads
            # the WHOLE date string here and would crash on 年 — read the
            # post-year remainder instead
            day = rest
        if day:
            day = num_to_hanzi(day[:-1]) + day[-1]
    return year + month + day


def read_money(money: str) -> str:
    """Cardinal-read every number inside a currency expression
    (reference Money.money2chntext)."""
    for m, _ in re.findall(r"(\d+(\.\d+)?)", money):
        money = money.replace(m, num_to_hanzi(m))
    return money


def read_telephone(tel: str, fixed: bool = False) -> str:
    """Digit-wise reading; landlines split at '-', mobiles at spaces with
    a stripped '+' (reference TelePhone.telephone2chntext)."""
    parts = tel.split("-") if fixed else tel.strip("+").split()
    return "".join(num_to_hanzi(p, per_digit=True, use_liang=False)
                   for p in parts)


def read_fraction(frac: str) -> str:
    """'3/4' -> 四分之三 (reference Fraction.fraction2chntext)."""
    numerator, denominator = frac.split("/")
    return num_to_hanzi(denominator) + "分之" + num_to_hanzi(numerator)


def read_percentage(pct: str) -> str:
    """'12.5%' -> 百分之十二点五 (reference Percentage)."""
    return "百分之" + num_to_hanzi(pct.strip().strip("%"))


class NSWNormalizer:
    """Drop-in analogue of the reference ``NSWNormalizer``: same rule
    order, same first-occurrence substitution semantics (each match is
    substituted with ``str.replace(..., 1)`` exactly as the reference
    does, so outputs are comparable character-for-character)."""

    def __init__(self, raw_text: str):
        self.raw_text = "^" + raw_text + "$"

    def normalize(self, remove_punc: bool = True) -> str:
        text = self.raw_text

        # dates
        for groups in re.findall(
                r"\D+((([089]\d|(19|20)\d{2})年)?(\d{1,2}月(\d{1,2}[日号])?)?)",
                text):
            if groups[0]:
                text = text.replace(groups[0], read_date(groups[0]), 1)

        # money
        for groups in re.findall(
                r"\D+((\d+(\.\d+)?)[多余几]?" + CURRENCY_UNITS +
                r"(\d" + CURRENCY_UNITS + r"?)?)", text):
            if groups[0]:
                text = text.replace(groups[0], read_money(groups[0]), 1)

        # mobile numbers
        for groups in re.findall(
                r"\D((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})\D",
                text):
            text = text.replace(groups[0], read_telephone(groups[0]), 1)
        # landlines
        for groups in re.findall(
                r"\D((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})\D", text):
            text = text.replace(groups[0],
                                read_telephone(groups[0], fixed=True), 1)

        # fractions
        for m in re.findall(r"(\d+/\d+)", text):
            text = text.replace(m, read_fraction(m), 1)

        # percentages
        text = text.replace("％", "%")
        for groups in re.findall(r"(\d+(\.\d+)?%)", text):
            text = text.replace(groups[0], read_percentage(groups[0]), 1)

        # cardinal + quantifier
        for groups in re.findall(
                r"(\d+(\.\d+)?)[多余几]?" + COM_QUANTIFIERS, text):
            text = text.replace(groups[0], num_to_hanzi(groups[0]), 1)

        # long digit strings (IDs, years outside date contexts, ...)
        for m in re.findall(r"(\d{4,32})", text):
            text = text.replace(
                m, num_to_hanzi(m, per_digit=True, use_liang=False), 1)

        # remaining cardinals
        for groups in re.findall(r"(\d+(\.\d+)?)", text):
            text = text.replace(groups[0], num_to_hanzi(groups[0]), 1)

        # <letter>二<letter> -> <letter>2<letter> (reference _particular)
        for groups in re.findall(r"(([a-zA-Z]+)二([a-zA-Z]+))", text):
            text = text.replace(groups[0], groups[1] + "2" + groups[2], 1)

        text = text.lstrip("^").rstrip("$")
        if remove_punc:
            punc = CHINESE_PUNC + string.punctuation
            text = text.translate(str.maketrans(punc, " " * len(punc)))
        return text


def normalize_zh_full(text: str, remove_punc: bool = True) -> str:
    """Module-level convenience wrapper."""
    return NSWNormalizer(text).normalize(remove_punc=remove_punc)
