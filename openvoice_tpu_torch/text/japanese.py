"""Japanese grapheme-to-phoneme (kana/romaji → IPA).

The reference *advertises* Japanese in its cleaner (`[JA]` spans dispatched at
the reference's openvoice/text/cleaners.py:9) but the handler
`japanese_to_ipa2` is never imported or defined — a latent NameError, so V1
Japanese never worked there.  This module supplies a working, self-contained
implementation whose output is constrained to the checkpoint's 87-symbol
inventory (text/symbols.py:55-73): the tokenizer silently drops anything
else, so every emitted character matters.

Scope (documented in docs/QA.md): input is hiragana, katakana, or Hepburn
romaji, plus digits and punctuation.  Kanji requires a reading dictionary
that does not ship in this image; kanji characters raise a clear error
instead of producing garbage audio.  Pitch-accent marks (↑↓ in the symbol
set) also require a lexicon and are not emitted.

Phonology implemented:
* moraic kana → IPA (ʃ, tʃ, ts, dʑ, ɸ, ç, ɾ, ɯ per standard Tokyo Japanese,
  all within the symbol set)
* sokuon っ → gemination of the following onset
* chouon ー and vowel sequences → doubled vowel letters (no ː in the set)
* ん → place assimilation: m before p/b/m, ŋ before k/g, n elsewhere
* the copula/topic particles は→わ, へ→え for the common greetings and a
  conservative particle heuristic (standalone single kana between spaces)
* positional number reading with rendaku/euphonic changes (300 さんびゃく,
  600 ろっぴゃく, 800 はっぴゃく, 1000 せん, 3000 さんぜん, 8000 はっせん, …)
"""

from __future__ import annotations

import logging
import re

_logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Kana tables
# ---------------------------------------------------------------------------

# base mora → (onset IPA, vowel letter); onset "" = bare vowel
_MORA: dict[str, tuple[str, str]] = {
    "あ": ("", "a"), "い": ("", "i"), "う": ("", "ɯ"), "え": ("", "e"), "お": ("", "o"),
    "か": ("k", "a"), "き": ("k", "i"), "く": ("k", "ɯ"), "け": ("k", "e"), "こ": ("k", "o"),
    "が": ("g", "a"), "ぎ": ("g", "i"), "ぐ": ("g", "ɯ"), "げ": ("g", "e"), "ご": ("g", "o"),
    "さ": ("s", "a"), "し": ("ʃ", "i"), "す": ("s", "ɯ"), "せ": ("s", "e"), "そ": ("s", "o"),
    "ざ": ("dz", "a"), "じ": ("dʑ", "i"), "ず": ("dz", "ɯ"), "ぜ": ("dz", "e"), "ぞ": ("dz", "o"),
    "た": ("t", "a"), "ち": ("tʃ", "i"), "つ": ("ts", "ɯ"), "て": ("t", "e"), "と": ("t", "o"),
    "だ": ("d", "a"), "ぢ": ("dʑ", "i"), "づ": ("dz", "ɯ"), "で": ("d", "e"), "ど": ("d", "o"),
    "な": ("n", "a"), "に": ("n", "i"), "ぬ": ("n", "ɯ"), "ね": ("n", "e"), "の": ("n", "o"),
    "は": ("h", "a"), "ひ": ("ç", "i"), "ふ": ("ɸ", "ɯ"), "へ": ("h", "e"), "ほ": ("h", "o"),
    "ば": ("b", "a"), "び": ("b", "i"), "ぶ": ("b", "ɯ"), "べ": ("b", "e"), "ぼ": ("b", "o"),
    "ぱ": ("p", "a"), "ぴ": ("p", "i"), "ぷ": ("p", "ɯ"), "ぺ": ("p", "e"), "ぽ": ("p", "o"),
    "ま": ("m", "a"), "み": ("m", "i"), "む": ("m", "ɯ"), "め": ("m", "e"), "も": ("m", "o"),
    "や": ("j", "a"), "ゆ": ("j", "ɯ"), "よ": ("j", "o"),
    "ら": ("ɾ", "a"), "り": ("ɾ", "i"), "る": ("ɾ", "ɯ"), "れ": ("ɾ", "e"), "ろ": ("ɾ", "o"),
    "わ": ("w", "a"), "ゐ": ("", "i"), "ゑ": ("", "e"), "を": ("", "o"),
    "ゔ": ("b", "ɯ"),
}

# youon: base i-row kana + small ゃゅょ → palatalized onset
_YOUON_VOWEL = {"ゃ": "a", "ゅ": "ɯ", "ょ": "o"}
_YOUON_ONSET = {
    "き": "kj", "ぎ": "gj", "し": "ʃ", "じ": "dʑ", "ち": "tʃ", "ぢ": "dʑ",
    "に": "nj", "ひ": "ç", "び": "bj", "ぴ": "pj", "み": "mj", "り": "ɾj",
}

_SMALL_VOWELS = {"ぁ": "a", "ぃ": "i", "ぅ": "ɯ", "ぇ": "e", "ぉ": "o"}

_PUNCT = {"、": ", ", "。": ". ", "！": "! ", "？": "? ", "・": " ", "「": "", "」": "",
          "『": "", "』": "", "（": "", "）": "", "，": ", ", "．": ". ", "～": "~", "ー": "ー"}

_GREETINGS = [
    ("こんにちは", "こんにちわ"),
    ("こんばんは", "こんばんわ"),
    ("では", "でわ"),
]

# ---------------------------------------------------------------------------
# Numbers → kana
# ---------------------------------------------------------------------------

_DIGITS = ["ぜろ", "いち", "に", "さん", "よん", "ご", "ろく", "なな", "はち", "きゅう"]
_HYAKU = {3: "さんびゃく", 6: "ろっぴゃく", 8: "はっぴゃく"}
_SEN = {3: "さんぜん", 8: "はっせん"}


def _under_10000(n: int) -> str:
    out = []
    sen, n = divmod(n, 1000)
    hyaku, n = divmod(n, 100)
    juu, ichi = divmod(n, 10)
    if sen:
        out.append(_SEN.get(sen, ("" if sen == 1 else _DIGITS[sen]) + "せん"))
    if hyaku:
        out.append(_HYAKU.get(hyaku, ("" if hyaku == 1 else _DIGITS[hyaku]) + "ひゃく"))
    if juu:
        out.append(("" if juu == 1 else _DIGITS[juu]) + "じゅう")
    if ichi:
        out.append(_DIGITS[ichi])
    return "".join(out)


def number_to_kana(s: str) -> str:
    """'2005' → 'にせんご'; decimals read digit-wise after てん."""
    if "." in s:
        head, tail = s.split(".", 1)
        return number_to_kana(head) + "てん" + "".join(_DIGITS[int(d)] for d in tail if d.isdigit())
    n = int(s)
    if n == 0:
        return _DIGITS[0]
    parts = []
    oku, n = divmod(n, 10**8)
    man, n = divmod(n, 10**4)
    if oku:
        parts.append(_under_10000(oku) + "おく")
    if man:
        parts.append(_under_10000(man) + "まん")
    if n:
        parts.append(_under_10000(n))
    return "".join(parts)


# ---------------------------------------------------------------------------
# Romaji → kana-level moras
# ---------------------------------------------------------------------------

_ROMAJI_TABLE = {
    "kya": "きゃ", "kyu": "きゅ", "kyo": "きょ", "gya": "ぎゃ", "gyu": "ぎゅ", "gyo": "ぎょ",
    "sha": "しゃ", "shu": "しゅ", "sho": "しょ", "sya": "しゃ", "syu": "しゅ", "syo": "しょ",
    "ja": "じゃ", "ju": "じゅ", "jo": "じょ", "jya": "じゃ", "jyu": "じゅ", "jyo": "じょ",
    "cha": "ちゃ", "chu": "ちゅ", "cho": "ちょ", "tya": "ちゃ", "tyu": "ちゅ", "tyo": "ちょ",
    "nya": "にゃ", "nyu": "にゅ", "nyo": "にょ", "hya": "ひゃ", "hyu": "ひゅ", "hyo": "ひょ",
    "bya": "びゃ", "byu": "びゅ", "byo": "びょ", "pya": "ぴゃ", "pyu": "ぴゅ", "pyo": "ぴょ",
    "mya": "みゃ", "myu": "みゅ", "myo": "みょ", "rya": "りゃ", "ryu": "りゅ", "ryo": "りょ",
    "shi": "し", "chi": "ち", "tsu": "つ", "fu": "ふ", "ji": "じ",
    "ka": "か", "ki": "き", "ku": "く", "ke": "け", "ko": "こ",
    "ga": "が", "gi": "ぎ", "gu": "ぐ", "ge": "げ", "go": "ご",
    "sa": "さ", "si": "し", "su": "す", "se": "せ", "so": "そ",
    "za": "ざ", "zi": "じ", "zu": "ず", "ze": "ぜ", "zo": "ぞ",
    "ta": "た", "ti": "ち", "tu": "つ", "te": "て", "to": "と",
    "da": "だ", "di": "ぢ", "du": "づ", "de": "で", "do": "ど",
    "na": "な", "ni": "に", "nu": "ぬ", "ne": "ね", "no": "の",
    "ha": "は", "hi": "ひ", "hu": "ふ", "he": "へ", "ho": "ほ",
    "ba": "ば", "bi": "び", "bu": "ぶ", "be": "べ", "bo": "ぼ",
    "pa": "ぱ", "pi": "ぴ", "pu": "ぷ", "pe": "ぺ", "po": "ぽ",
    "ma": "ま", "mi": "み", "mu": "む", "me": "め", "mo": "も",
    "ya": "や", "yu": "ゆ", "yo": "よ",
    "ra": "ら", "ri": "り", "ru": "る", "re": "れ", "ro": "ろ",
    "wa": "わ", "wo": "を",
    "a": "あ", "i": "い", "u": "う", "e": "え", "o": "お",
}
_ROMAJI_KEYS = sorted(_ROMAJI_TABLE, key=len, reverse=True)


def romaji_to_kana(text: str, strict: bool = True) -> str:
    """Hepburn/kunrei romaji → hiragana ('konnichiwa' → こんにちわ).

    strict=False logs-and-skips unparseable runs instead of raising
    (the served-degradation mode, matching ZH OOV behavior)."""
    out = []
    i = 0
    s = text.lower()
    while i < len(s):
        ch = s[i]
        if not ch.isalpha() and ch not in "'-":
            out.append("ー" if ch == "-" else ch)
            i += 1
            continue
        if ch == "'":  # explicit mora break (kon'nichi)
            i += 1
            continue
        # geminate: doubled consonant (except nn → ん + mora)
        if (i + 1 < len(s) and ch == s[i + 1] and ch not in "aiueon"):
            out.append("っ")
            i += 1
            continue
        if ch == "n":
            nxt = s[i + 1] if i + 1 < len(s) else ""
            if nxt and (nxt in "aiueoy"):
                pass  # na/ni/nya… handled by table below
            else:
                out.append("ん")
                i += 1
                if nxt == "n" and i + 1 < len(s) and s[i + 1] in "aiueoy":
                    continue  # 'nn' + vowel: ん + な row
                continue
        for key in _ROMAJI_KEYS:
            if s.startswith(key, i):
                out.append(_ROMAJI_TABLE[key])
                i += len(key)
                break
        else:
            if strict:
                raise ValueError(
                    f"cannot parse romaji at {s[i:i+6]!r}; "
                    "JA input must be kana or Hepburn romaji"
                )
            _logger.warning("unparseable romaji at %r; skipped", s[i : i + 6])
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Kana → IPA
# ---------------------------------------------------------------------------

def _katakana_to_hiragana(text: str) -> str:
    return "".join(
        chr(ord(c) - 0x60) if "ァ" <= c <= "ヶ" else c
        for c in text
    )


def _normalize(text: str, strict: bool = True) -> str:
    text = text.strip()
    for src, dst in _GREETINGS:
        text = text.replace(src, dst)
    # common kanji words → kana via longest-match table (r3); OOV kanji are
    # handled downstream per `strict` — see text/ja_readings.py
    from openvoice_tpu_torch.text.ja_readings import replace_kanji_words

    text = replace_kanji_words(text)
    text = re.sub(r"\d+(?:\.\d+)?", lambda m: number_to_kana(m.group()), text)
    text = _katakana_to_hiragana(text)
    for src, dst in _PUNCT.items():
        text = text.replace(src, dst)
    # romaji runs → kana
    text = re.sub(
        r"[A-Za-z][A-Za-z'\-]*",
        lambda m: romaji_to_kana(m.group(), strict=strict),
        text,
    )
    return text


def kana_to_ipa(text: str, strict: bool = True) -> str:
    """Hiragana string (plus ascii punctuation) → IPA mora sequence.

    strict=True raises on OOV kanji / unsupported characters (the library
    default — a clear error beats garbage audio in scripted use);
    strict=False logs-and-skips them, matching ZH's OOV degradation
    (text/mandarin.py) — the serving tier uses this so one rare kanji
    degrades a request instead of throwing (docs/QA.md)."""
    moras: list[tuple[str, str]] = []  # (onset, vowel); punctuation as ("", ".")
    i = 0
    pending_geminate = False
    while i < len(text):
        ch = text[i]
        nxt = text[i + 1] if i + 1 < len(text) else ""
        if ch == "っ":
            pending_geminate = True
            i += 1
            continue
        if ch == "ん":
            moras.append(("N", ""))  # resolved after the pass
            i += 1
            continue
        if ch == "ー":
            if moras and moras[-1][1]:
                moras.append(("", moras[-1][1]))
            i += 1
            continue
        if ch in _SMALL_VOWELS:
            moras.append(("", _SMALL_VOWELS[ch]))
            i += 1
            continue
        if ch in _MORA:
            if nxt in _YOUON_VOWEL and ch in _YOUON_ONSET:
                onset, vowel = _YOUON_ONSET[ch], _YOUON_VOWEL[nxt]
                i += 2
            else:
                onset, vowel = _MORA[ch]
                i += 1
            if pending_geminate and onset:
                onset = onset[0] + onset
                pending_geminate = False
            # long-vowel merges: おう→oo, えい→ee (bare う/い after o/e mora)
            if not onset and moras and moras[-1][1]:
                prev_v = moras[-1][1]
                if vowel == "ɯ" and prev_v == "o":
                    vowel = "o"
                elif vowel == "i" and prev_v == "e":
                    vowel = "e"
            moras.append((onset, vowel))
            continue
        if ch.isspace() or ch in ",.!?-~…":
            moras.append(("", ch))
            i += 1
            continue
        if "一" <= ch <= "鿿":
            if strict:
                raise ValueError(
                    f"kanji {ch!r} requires a reading dictionary (not shipped); "
                    "write JA input in kana or romaji"
                )
            _logger.warning("no reading for kanji %r; skipped", ch)
            i += 1
            continue
        if strict:
            raise ValueError(f"unsupported character {ch!r} in JA text")
        _logger.warning("unsupported character %r in JA text; skipped", ch)
        i += 1
        continue

    # resolve ん by place of the following onset
    out = []
    for idx, (onset, vowel) in enumerate(moras):
        if onset == "N":
            nxt_on = moras[idx + 1][0] if idx + 1 < len(moras) else ""
            first = nxt_on[:1]
            if first in ("p", "b", "m"):
                out.append("m")
            elif first in ("k", "g"):
                out.append("ŋ")
            else:
                out.append("n")
            continue
        out.append(onset + vowel)
    return "".join(out)


def japanese_to_ipa2(text: str, strict: bool = True) -> str:
    """Full JA pipeline: normalize → kana → IPA (cleaner entry point).

    strict=False degrades on OOV (warn-and-skip, like ZH) instead of
    raising — the mode the serving ladder uses."""
    ipa = kana_to_ipa(_normalize(text, strict=strict), strict=strict)
    ipa = re.sub(r"\s+", " ", ipa).strip()
    return ipa
