"""Mandarin grapheme-to-phoneme: hanzi → pinyin → IPA.

The reference chain (text/mandarin.py:236-314) is cn2an number conversion →
jieba segmentation → pypinyin BOPOMOFO → regex chains to IPA.  This
implementation maps pinyin *directly* to the same target IPA inventory
(initial/final decomposition instead of a bopomofo intermediate — same
output, one fewer representation):

    tone marks:  1→'→'  2→'↑'  3→'↓↑'  4→'↓'  5(neutral)→''
    e.g.  你好 → ni3 hao3 → "ni↓↑xɑʊ↓↑"

Pinyin lookup is pluggable: pypinyin is used when importable; otherwise an
embedded table of frequent characters covers common text and unknown hanzi
are skipped with a warning (the tokenizer would drop unknown symbols anyway).
Number reading (cn2an equivalent) is implemented natively.
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Numbers → Chinese reading (cn2an.an2cn equivalent)
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
_SMALL_UNITS = ["", "十", "百", "千"]
_BIG_UNITS = ["", "万", "亿"]


def _int_to_chinese(n: int) -> str:
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            if parts and not parts[-1].endswith("零"):
                parts.append("零")
            continue
        s = ""
        zero_pending = False
        for pos in range(3, -1, -1):
            d = (g // 10**pos) % 10
            if d == 0:
                if s:
                    zero_pending = True
                continue
            if zero_pending:
                s += "零"
                zero_pending = False
            s += _DIGITS[d] + (_SMALL_UNITS[pos] if pos else "")
        if gi > 0:
            s += _BIG_UNITS[gi]
        # leading-zero link between groups (e.g. 10001 → 一万零一)
        if parts and groups[gi + 1] % 10 == 0 if gi + 1 < len(groups) else False:
            pass
        parts.append(s)
    out = "".join(parts)
    # 一十X → 十X at the very front (10-19)
    out = re.sub("^一十", "十", out)
    return out.rstrip("零") or "零"


def number_to_chinese(text: str) -> str:
    def repl(m: re.Match) -> str:
        s = m.group(0)
        if "." in s:
            a, b = s.split(".", 1)
            return _int_to_chinese(int(a)) + "点" + "".join(_DIGITS[int(d)] for d in b)
        return _int_to_chinese(int(s))

    return re.sub(r"\d+(?:\.\d+)?", repl, text)


# ---------------------------------------------------------------------------
# Pinyin lookup backends
# ---------------------------------------------------------------------------

try:  # optional, best-quality backend
    from pypinyin import lazy_pinyin, Style  # type: ignore

    def _word_to_pinyin(word: str) -> list[str]:
        return lazy_pinyin(word, style=Style.TONE3, neutral_tone_with_five=True)

    _HAVE_PYPINYIN = True
except ImportError:
    _HAVE_PYPINYIN = False

    from openvoice_tpu_torch.text.pinyin_data import CHAR_PINYIN, WORD_PINYIN

    def _word_to_pinyin(word: str) -> list[str]:
        if word in WORD_PINYIN:
            return WORD_PINYIN[word].split()
        out = []
        for ch in word:
            py = CHAR_PINYIN.get(ch)
            if py is None:
                logger.warning("no pinyin for %r; skipped", ch)
                continue
            out.append(py)
        return out


# ---------------------------------------------------------------------------
# Pinyin → IPA (reference inventory: _bopomofo_to_ipa composition)
# ---------------------------------------------------------------------------

_INITIALS = {
    "b": "p⁼", "p": "pʰ", "m": "m", "f": "f",
    "d": "t⁼", "t": "tʰ", "n": "n", "l": "l",
    "g": "k⁼", "k": "kʰ", "h": "x",
    "j": "tʃ⁼", "q": "tʃʰ", "x": "ʃ",
    "zh": "ts`⁼", "ch": "ts`ʰ", "sh": "s`", "r": "ɹ`",
    "z": "ts⁼", "c": "tsʰ", "s": "s",
}

# finals in pinyin orthography (after initial stripped), standalone-syllable
# spellings normalized first.  values follow the reference's bopomofo→ipa
# table composed with its j/w glide rewrites (mandarin.py:306-309).
_FINALS = {
    "a": "a", "o": "o", "e": "ə", "ê": "ɛ",
    "ai": "aɪ", "ei": "eɪ", "ao": "ɑʊ", "ou": "oʊ",
    "an": "an", "en": "ən", "ang": "ɑŋ", "eng": "əŋ", "ong": "ʊŋ",
    "er": "əɹ`",
    "i": "i", "ia": "ja", "ie": "jɛ", "iao": "jɑʊ", "iu": "joʊ",
    "ian": "jɛn", "in": "in", "iang": "jɑŋ", "ing": "iŋ", "iong": "jʊŋ",
    "u": "u", "ua": "wa", "uo": "wo", "uai": "waɪ", "ui": "weɪ",
    "uan": "wan", "un": "wən", "uang": "wɑŋ", "ueng": "wəŋ",
    "ü": "ɥ", "üe": "ɥɛ", "üan": "ɥæn", "ün": "ɥn",
    "v": "ɥ", "ve": "ɥɛ", "van": "ɥæn", "vn": "ɥn",
}

# whole-syllable irregulars (zero-initial spellings and retroflex/sibilant
# "i" finals, matching the reference's post-regex fixups)
_SYLLABLE_SPECIAL = {
    "zhi": "ts`⁼ɹ`", "chi": "ts`ʰɹ`", "shi": "s`ɹ`", "ri": "ɹ`ɹ`",
    "zi": "ts⁼ɹ", "ci": "tsʰɹ", "si": "sɹ",
    "yi": "i", "ya": "ja", "ye": "jɛ", "yao": "jɑʊ", "you": "joʊ",
    "yan": "jɛn", "yin": "in", "yang": "jɑŋ", "ying": "iŋ", "yong": "jʊŋ",
    "wu": "u", "wa": "wa", "wo": "wo", "wai": "waɪ", "wei": "weɪ",
    "wan": "wan", "wen": "wən", "wang": "wɑŋ", "weng": "wəŋ",
    "yu": "ɥ", "yue": "ɥɛ", "yuan": "ɥæn", "yun": "ɥn",
    "hm": "xm", "hng": "xŋ", "m": "m", "n": "n", "ng": "ŋ",
}

_TONE_MARKS = {"1": "→", "2": "↑", "3": "↓↑", "4": "↓", "5": ""}

_PUNCT_MAP = {"，": ",", "。": ".", "！": "!", "？": "?", "—": "-", "、": ",", "；": ",", "：": ","}

# Latin letters read as letter names (reference _latin_to_bopomofo composed
# with bopomofo→ipa)
_LATIN_IPA = {
    "a": "eɪ→", "b": "p⁼i↓", "c": "si→", "d": "t⁼i↓", "e": "i↓",
    "f": "ɛfu↓", "g": "tʃ⁼i↓", "h": "ɛtʃʰɥ↓", "i": "aɪ↓", "j": "tʃ⁼eɪ↓",
    "k": "kʰeɪ↓", "l": "ɛlo↓", "m": "ɛmu↓", "n": "ən→", "o": "oʊ→",
    "p": "pʰi→", "q": "kʰjoʊ→", "r": "a↓", "s": "ɛsɹ↓", "t": "tʰi↓",
    "u": "joʊ→", "v": "wi→", "w": "t⁼a↓p⁼u↓ljoʊ↓", "x": "ɛ→kʰu↓sɹ↓",
    "y": "waɪ↓", "z": "ts⁼eɪ↓",
}


def pinyin_to_ipa(syllable: str) -> str:
    """One tone-numbered pinyin syllable (e.g. 'zhong1') → IPA."""
    m = re.fullmatch(r"([a-zü:êv]+)([1-5]?)", syllable.lower())
    if not m:
        return syllable
    body, tone = m.group(1).replace("u:", "ü"), m.group(2) or "5"
    if body in _SYLLABLE_SPECIAL:
        ipa = _SYLLABLE_SPECIAL[body]
    else:
        initial = ""
        for cand in ("zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
                     "g", "k", "h", "j", "q", "x", "r", "z", "c", "s"):
            if body.startswith(cand):
                initial = cand
                break
        final = body[len(initial):]
        # j/q/x + u spellings actually mean ü
        if initial in ("j", "q", "x") and final.startswith("u"):
            final = "ü" + final[1:]
        ipa_final = _FINALS.get(final)
        if ipa_final is None:
            logger.warning("unknown pinyin final %r in %r", final, syllable)
            return ""
        ipa = _INITIALS.get(initial, "") + ipa_final
    return ipa + _TONE_MARKS.get(tone, "")


def chinese_to_ipa(text: str) -> str:
    """Full hanzi text → IPA (reference chinese_to_ipa, mandarin.py:306-314)."""
    import jieba

    text = number_to_chinese(text)
    for src, dst in _PUNCT_MAP.items():
        text = text.replace(src, dst)
    words = jieba.lcut(text, cut_all=False)
    out: list[str] = []
    for word in words:
        if not re.search(r"[一-鿿]", word):
            # latin letters are read as letter names, like the reference
            chunk = "".join(_LATIN_IPA.get(ch.lower(), ch) for ch in word)
            out.append(chunk)
            continue
        syllables = _word_to_pinyin(word)
        out.append("".join(pinyin_to_ipa(s) for s in syllables))
    result = " ".join(s for s in out if s.strip() != "" or s == " ")
    return re.sub(r"\s+", " ", result).strip()
