"""Korean grapheme-to-phoneme (hangul → IPA).

The reference *advertises* Korean in its cleaner (`[KO]` spans dispatched at
the reference's openvoice/text/cleaners.py:11) but the handler
`korean_to_ipa` is never imported or defined — the same latent NameError as
Japanese, so V1 Korean never worked there.  This is a working, self-contained
implementation: hangul is decomposed arithmetically (U+AC00 block), standard
pronunciation rules are applied on the jamo sequence, and the result is
rendered in IPA constrained to the checkpoint's 87-symbol inventory
(text/symbols.py:55-73) — tense consonants use the `⁼` mark and aspirates
`ʰ`, the same diacritics the inventory carries for Mandarin.

Rules implemented (Standard Korean pronunciation, 표준 발음법):
* liaison (연음): 국어 → 구거
* ㅎ weakening + aspiration fusion: 좋다 → 조타, 입학 → 이팍
* nasalization (비음화): 합니다 → 함니다, 식량 → 싱냥
* liquidization (유음화): 신라 → 실라
* palatalization (구개음화): 굳이 → 구지
* post-obstruent tensification (경음화): 학교 → 학꾜
* coda neutralization to the 7 representatives (받침 중화)
* word-initial lax-stop devoicing, intervocalic voicing: 바보 → pabo
* sino-Korean positional number reading (2005 → 이천오)

Scope: hangul + digits + punctuation; other scripts raise a clear error.
"""

from __future__ import annotations

import re

_LEADS = ["ㄱ", "ㄲ", "ㄴ", "ㄷ", "ㄸ", "ㄹ", "ㅁ", "ㅂ", "ㅃ", "ㅅ", "ㅆ", "ㅇ",
          "ㅈ", "ㅉ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]
_VOWELS = ["ㅏ", "ㅐ", "ㅑ", "ㅒ", "ㅓ", "ㅔ", "ㅕ", "ㅖ", "ㅗ", "ㅘ", "ㅙ", "ㅚ",
           "ㅛ", "ㅜ", "ㅝ", "ㅞ", "ㅟ", "ㅠ", "ㅡ", "ㅢ", "ㅣ"]
_TAILS = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ", "ㄻ", "ㄼ", "ㄽ",
          "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ", "ㅆ", "ㅇ", "ㅈ", "ㅊ", "ㅋ",
          "ㅌ", "ㅍ", "ㅎ"]

# cluster tails → (kept tail, consonant available for liaison/rules)
_CLUSTER = {"ㄳ": ("ㄱ", "ㅅ"), "ㄵ": ("ㄴ", "ㅈ"), "ㄶ": ("ㄴ", "ㅎ"),
            "ㄺ": ("ㄹ", "ㄱ"), "ㄻ": ("ㄹ", "ㅁ"), "ㄼ": ("ㄹ", "ㅂ"),
            "ㄽ": ("ㄹ", "ㅅ"), "ㄾ": ("ㄹ", "ㅌ"), "ㄿ": ("ㄹ", "ㅍ"),
            "ㅀ": ("ㄹ", "ㅎ"), "ㅄ": ("ㅂ", "ㅅ")}

# coda neutralization to the 7 representatives (받침 ㄱㄴㄷㄹㅁㅂㅇ)
_NEUTRAL = {"ㄱ": "k", "ㄲ": "k", "ㅋ": "k", "ㄴ": "n", "ㄷ": "t", "ㅅ": "t",
            "ㅆ": "t", "ㅈ": "t", "ㅊ": "t", "ㅌ": "t", "ㅎ": "t", "ㄹ": "l",
            "ㅁ": "m", "ㅂ": "p", "ㅍ": "p", "ㅇ": "ŋ", "": ""}

_ASPIRATE = {"ㄱ": "ㅋ", "ㄷ": "ㅌ", "ㅂ": "ㅍ", "ㅈ": "ㅊ"}
_TENSE = {"ㄱ": "ㄲ", "ㄷ": "ㄸ", "ㅂ": "ㅃ", "ㅅ": "ㅆ", "ㅈ": "ㅉ"}

# lead jamo → (word-initial/post-obstruent IPA, intervocalic IPA)
_LEAD_IPA = {
    "ㄱ": ("k", "g"), "ㄲ": ("k⁼", "k⁼"), "ㅋ": ("kʰ", "kʰ"),
    "ㄷ": ("t", "d"), "ㄸ": ("t⁼", "t⁼"), "ㅌ": ("tʰ", "tʰ"),
    "ㅂ": ("p", "b"), "ㅃ": ("p⁼", "p⁼"), "ㅍ": ("pʰ", "pʰ"),
    "ㅈ": ("tʃ", "dʑ"), "ㅉ": ("tʃ⁼", "tʃ⁼"), "ㅊ": ("tʃʰ", "tʃʰ"),
    "ㅅ": ("s", "s"), "ㅆ": ("s⁼", "s⁼"), "ㅎ": ("h", "h"),
    "ㅁ": ("m", "m"), "ㄴ": ("n", "n"), "ㄹ": ("ɾ", "ɾ"), "ㅇ": ("", ""),
}

_VOWEL_IPA = ["a", "ɛ", "ja", "jɛ", "ə", "e", "jə", "je", "o", "wa", "wɛ",
              "we", "jo", "u", "wə", "we", "wi", "ju", "ɯ", "ɯi", "i"]

_TAIL_IPA = {"k": "k", "n": "n", "t": "t", "l": "ɫ", "m": "m", "p": "p",
             "ŋ": "ŋ", "": ""}

# ---------------------------------------------------------------------------
# Numbers → hangul (sino-Korean)
# ---------------------------------------------------------------------------

_DIGITS = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]


def _under_10000(n: int) -> str:
    out = []
    for unit, name in ((1000, "천"), (100, "백"), (10, "십")):
        d, n = divmod(n, unit)
        if d:
            out.append(("" if d == 1 else _DIGITS[d]) + name)
    if n:
        out.append(_DIGITS[n])
    return "".join(out)


def number_to_hangul(s: str) -> str:
    """'2005' → '이천오'; decimals read digit-wise after 점."""
    if "." in s:
        head, tail = s.split(".", 1)
        return number_to_hangul(head) + "점" + "".join(
            _DIGITS[int(d)] for d in tail if d.isdigit())
    n = int(s)
    if n == 0:
        return _DIGITS[0]
    parts = []
    ok, n = divmod(n, 10**8)
    man, n = divmod(n, 10**4)
    if ok:
        parts.append(_under_10000(ok) + "억")
    if man:
        parts.append(_under_10000(man) + "만")
    if n:
        parts.append(_under_10000(n))
    return "".join(parts)


# ---------------------------------------------------------------------------
# Hangul → jamo → pronunciation rules → IPA
# ---------------------------------------------------------------------------

def decompose(ch: str) -> tuple[str, str, str]:
    code = ord(ch) - 0xAC00
    return (_LEADS[code // 588], _VOWELS[(code % 588) // 28], _TAILS[code % 28])


def _is_hangul(ch: str) -> bool:
    return "가" <= ch <= "힣"


def _apply_rules(syls: list[list[str]]) -> list[list[str]]:
    """In-place pronunciation rules over [(lead, vowel, tail), ...]."""
    # pass 1: tail/lead interactions, left to right
    for i in range(len(syls)):
        lead, vowel, tail = syls[i]
        nxt = syls[i + 1] if i + 1 < len(syls) else None

        t1, t2 = _CLUSTER.get(tail, (tail, ""))

        if nxt is not None:
            nl = nxt[0]
            # ㅎ fusion: tail(+cluster) ㅎ + lax lead → aspirated lead
            if (t2 == "ㅎ" or t1 == "ㅎ") and nl in _ASPIRATE:
                nxt[0] = _ASPIRATE[nl]
                syls[i][2] = t1 if t2 == "ㅎ" else ""
                continue
            # tail ㅎ before vowel drops entirely
            if t1 == "ㅎ" and not t2 and nl == "ㅇ":
                syls[i][2] = ""
                continue
            # obstruent tail + lead ㅎ → aspirated lead (입학 → 이팍)
            if nl == "ㅎ" and not t2 and t1 in _ASPIRATE:
                nxt[0] = _ASPIRATE[t1]
                syls[i][2] = ""
                continue
            # cluster's second consonant + lead ㅎ → aspirate (밝히다 → 발키다)
            if nl == "ㅎ" and t2 in _ASPIRATE:
                nxt[0] = _ASPIRATE[t2]
                syls[i][2] = t1
                continue
            # palatalization: ㄷ/ㅌ + 이 → 지/치 (굳이 → 구지)
            if nl == "ㅇ" and nxt[1] == "ㅣ" and not t2 and t1 in ("ㄷ", "ㅌ"):
                nxt[0] = "ㅈ" if t1 == "ㄷ" else "ㅊ"
                syls[i][2] = ""
                continue
            # liaison: tail moves to empty onset (국어 → 구거)
            if nl == "ㅇ" and (t1 or t2):
                if t2:
                    nxt[0] = "ㅆ" if t2 == "ㅅ" and t1 == "ㄹ" else t2
                    syls[i][2] = t1
                else:
                    nxt[0] = t1
                    syls[i][2] = ""
                continue
        # no interaction: cluster reduces to its representative — ㄺ/ㄻ/ㄿ keep
        # the second consonant (읽다 → 익따, 삶 → 삼), the rest keep the first
        if t2:
            syls[i][2] = t2 if tail in ("ㄺ", "ㄻ", "ㄿ") else t1

    return syls


def _render(syls: list[list[str]], word_initial: bool) -> str:
    # neutralize tails, then nasal/liquid/tense interactions need the
    # neutralized form
    tails = [_NEUTRAL.get(t, "") for _, _, t in syls]

    for i in range(len(syls) - 1):
        nl = syls[i + 1][0]
        # lead ㄹ after any consonant except ㄹ → ㄴ (종로 → 종노)
        if nl == "ㄹ" and tails[i] in ("k", "t", "p", "m", "ŋ", "n"):
            if tails[i] == "n":
                tails[i] = "l"  # liquidization 신라 → 실라
            else:
                syls[i + 1][0] = nl = "ㄴ"
        # nasalization of obstruent tails before nasals
        if nl in ("ㄴ", "ㅁ") and tails[i] in ("k", "t", "p"):
            tails[i] = {"k": "ŋ", "t": "n", "p": "m"}[tails[i]]
        # tail ㄹ + lead ㄴ → ㄹㄹ (칼날 → 칼랄)
        if nl == "ㄴ" and tails[i] == "l":
            syls[i + 1][0] = "ㄹ"
        # tensification after obstruent tails (학교 → 학꾜)
        if tails[i] in ("k", "t", "p") and nl in _TENSE:
            syls[i + 1][0] = _TENSE[nl]

    out = []
    for i, (lead, vowel, _) in enumerate(syls):
        initial = word_initial and i == 0
        after_obstruent = i > 0 and tails[i - 1] in ("k", "t", "p")
        idx = 0 if (initial or after_obstruent) else 1
        lead_ipa = _LEAD_IPA[lead][idx]
        v_ipa = _VOWEL_IPA[_VOWELS.index(vowel)]
        # ㅅ → ʃ before i/j (시 → ʃi)
        if lead in ("ㅅ", "ㅆ") and (v_ipa == "i" or v_ipa.startswith("j")):
            lead_ipa = "ʃ" + ("⁼" if lead == "ㅆ" else "")
        # ㄹㄹ renders as a lateral geminate ɫɫ
        if lead == "ㄹ" and i > 0 and tails[i - 1] == "l":
            lead_ipa = "ɫ"
        out.append(lead_ipa + v_ipa + _TAIL_IPA[tails[i]])
    return "".join(out)


def korean_word_to_ipa(word: str) -> str:
    syls = [list(decompose(ch)) for ch in word]
    return _render(_apply_rules(syls), word_initial=True)


_PUNCT = {"、": ", ", "。": ". ", "，": ", ", "．": ". ", "！": "! ", "？": "? ",
          "…": "…", "~": "~"}


def korean_to_ipa(text: str) -> str:
    """Full KO pipeline: numbers → hangul, rules, IPA (cleaner entry)."""
    text = text.strip()
    for src, dst in _PUNCT.items():
        text = text.replace(src, dst)
    text = re.sub(r"\d+(?:\.\d+)?", lambda m: number_to_hangul(m.group()), text)

    out: list[str] = []
    for chunk in re.split(r"(\s+)", text):
        if not chunk or chunk.isspace():
            out.append(" ")
            continue
        word: list[str] = []
        for ch in chunk:
            if _is_hangul(ch):
                word.append(ch)
                continue
            if word:
                out.append(korean_word_to_ipa("".join(word)))
                word = []
            if ch in ",.!?-~…":
                out.append(ch)
            else:
                raise ValueError(
                    f"unsupported character {ch!r} in KO text; "
                    "KO input must be hangul, digits, or punctuation"
                )
        if word:
            out.append(korean_word_to_ipa("".join(word)))
    return re.sub(r"\s+", " ", "".join(out)).strip()
