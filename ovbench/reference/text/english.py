"""English text normalization + grapheme-to-phoneme (IPA).

The reference pipeline (text/english.py:160-181) is: unidecode → lowercase →
abbreviation expansion → number normalization → `eng_to_ipa` (CMU-dict based)
→ dark-l marking → IPA2 substitutions (r→ɹ, ʤ→dʒ, ʧ→tʃ).

This implementation is self-contained (no external lexicon ships in this
image): the normalizer is a full reimplementation; G2P is a built-in
exceptions lexicon + an NRL-style (Elovitz et al. 1976) letter-to-sound rule
engine producing the same IPA symbol inventory.  A CMU-style lexicon can be
plugged in via `register_lexicon` when available — the rule engine is the
fallback, not the architecture.

Deliberate reference-parity quirks: symbols outside the checkpoint inventory
(ʌ, ɜ, stress on rule-derived words) are *emitted anyway* — the tokenizer's
silent drop (text/__init__.py:25-26) is part of the trained contract.
"""

from __future__ import annotations

import re
import unicodedata

# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    """Integer → English words, no 'and' (inflect andword='' style)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _TENS[t] + ("-" + _UNITS[u] if u else "")
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _UNITS[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if "-" in last:
        head, tail = last.rsplit("-", 1)
        tail = _ordinalize_word(tail)
        last = head + "-" + tail
    else:
        last = _ordinalize_word(last)
    parts[-1] = last
    return " ".join(parts)


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    return w + "th"


_COMMA_NUMBER_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"[0-9]+(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        du = "dollar" if dollars == 1 else "dollars"
        cu = "cent" if cents == 1 else "cents"
        return f"{dollars} {du}, {cents} {cu}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_plain_number(m: re.Match) -> str:
    num = int(m.group(0))
    # year-style reading for 1001-2999 (reference text/english.py:131-143)
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        head, tail = divmod(num, 100)
        tail_words = "oh " + number_to_words(tail) if tail < 10 else number_to_words(tail)
        return number_to_words(head) + " " + tail_words
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _COMMA_NUMBER_RE.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _POUNDS_RE.sub(r"\1 pounds", text)
    text = _DOLLARS_RE.sub(_expand_dollars, text)
    text = _DECIMAL_RE.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ORDINAL_RE.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _NUMBER_RE.sub(_expand_plain_number, text)
    return text


def ascii_fold(text: str) -> str:
    """Minimal unidecode: NFKD-decompose and drop combining marks."""
    out = unicodedata.normalize("NFKD", text)
    return "".join(ch for ch in out if not unicodedata.combining(ch) and ord(ch) < 128)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text)


def normalize_english(text: str) -> str:
    text = ascii_fold(text).lower()
    text = expand_abbreviations(text)
    text = normalize_numbers(text)
    return text


# ---------------------------------------------------------------------------
# G2P: exceptions lexicon (IPA with stress, eng_to_ipa conventions)
# ---------------------------------------------------------------------------

_LEXICON: dict[str, str] = {
    "a": "ə", "an": "ən", "the": "ðə", "of": "əv", "to": "tu", "and": "ənd",
    "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "ju", "that": "ðæt",
    "he": "hi", "she": "ʃi", "we": "wi", "was": "wəz", "for": "fɔr",
    "on": "ɑn", "are": "ɑr", "as": "æz", "with": "wɪð", "his": "hɪz",
    "her": "hər", "they": "ðeɪ", "i": "aɪ", "at": "æt", "be": "bi",
    "this": "ðɪs", "have": "hæv", "from": "frəm", "or": "ɔr", "had": "hæd",
    "by": "baɪ", "but": "bət", "what": "wət", "all": "ɔl", "were": "wər",
    "when": "wɛn", "there": "ðɛr", "can": "kæn", "said": "sɛd", "who": "hu",
    "do": "du", "does": "dəz", "done": "dən", "been": "bɪn", "their": "ðɛr",
    "if": "ɪf", "will": "wɪl", "would": "wʊd", "could": "kʊd", "should": "ʃʊd",
    "one": "wən", "once": "wəns", "two": "tu", "four": "fɔr", "eight": "eɪt",
    "about": "əˈbaʊt", "out": "aʊt", "many": "ˈmɛni", "any": "ˈɛni",
    "then": "ðɛn", "them": "ðɛm", "these": "ðiz", "those": "ðoʊz", "so": "soʊ",
    "some": "səm", "into": "ˈɪntu", "more": "mɔr", "other": "ˈəðər",
    "no": "noʊ", "not": "nɑt", "only": "ˈoʊnli", "over": "ˈoʊvər",
    "very": "ˈvɛri", "my": "maɪ", "me": "mi", "your": "jʊr", "our": "aʊər",
    "its": "ɪts", "also": "ˈɔlsoʊ", "after": "ˈæftər", "use": "juz",
    "how": "haʊ", "because": "bɪˈkɔz", "people": "ˈpipəl", "say": "seɪ",
    "says": "sɛz", "most": "moʊst", "good": "gʊd", "know": "noʊ",
    "where": "wɛr", "through": "θru", "thought": "θɔt", "though": "ðoʊ",
    "enough": "ɪˈnəf", "tough": "təf", "rough": "rəf", "laugh": "læf",
    "here": "hir", "were't": "wərnt", "again": "əˈgɛn", "against": "əˈgɛnst",
    "every": "ˈɛvəri", "gone": "gɔn", "great": "greɪt", "heart": "hɑrt",
    "pretty": "ˈprɪti", "eye": "aɪ", "eyes": "aɪz", "water": "ˈwɔtər",
    "woman": "ˈwʊmən", "women": "ˈwɪmən", "world": "wərld", "word": "wərd",
    "work": "wərk", "world's": "wərldz", "love": "ləv", "give": "gɪv",
    "live": "lɪv", "have't": "hævənt", "move": "muv", "prove": "pruv",
    "whose": "huz", "own": "oʊn", "friend": "frɛnd", "friends": "frɛndz",
    "busy": "ˈbɪzi", "business": "ˈbɪznəs", "island": "ˈaɪlənd",
    "answer": "ˈænsər", "often": "ˈɔfən", "hour": "aʊər", "honest": "ˈɑnəst",
    "voice": "vɔɪs", "choice": "ʧɔɪs", "young": "jəŋ", "touch": "təʧ",
    "machine": "məˈʃin", "police": "pəˈlis", "technology": "tɛkˈnɑləʤi",
    "science": "ˈsaɪəns", "ocean": "ˈoʊʃən", "special": "ˈspɛʃəl",
    "sure": "ʃʊr", "sugar": "ˈʃʊgər", "english": "ˈɪŋglɪʃ",
    "language": "ˈlæŋgwəʤ", "question": "ˈkwɛsʧən", "nature": "ˈneɪʧər",
    "picture": "ˈpɪkʧər", "future": "ˈfjuʧər", "education": "ˌɛʤəˈkeɪʃən",
    "beautiful": "ˈbjutəfəl", "idea": "aɪˈdiə", "area": "ˈɛriə",
    "europe": "ˈjʊrəp", "music": "ˈmjuzɪk", "usually": "ˈjuʒəwəli",
    "measure": "ˈmɛʒər", "pleasure": "ˈplɛʒər", "vision": "ˈvɪʒən",
    "decision": "dɪˈsɪʒən", "television": "ˈtɛləˌvɪʒən", "heard": "hərd",
    "early": "ˈərli", "earth": "ərθ", "learn": "lərn", "body": "ˈbɑdi",
    "mother": "ˈməðər", "father": "ˈfɑðər", "brother": "ˈbrəðər",
    "together": "təˈgɛðər", "weather": "ˈwɛðər", "whether": "ˈwɛðər",
    "both": "boʊθ", "month": "mənθ", "nothing": "ˈnəθɪŋ",
    "something": "ˈsəmθɪŋ", "anything": "ˈɛniˌθɪŋ", "everything": "ˈɛvriˌθɪŋ",
    "today": "təˈdeɪ", "tomorrow": "təˈmɑˌroʊ", "yesterday": "ˈjɛstərˌdeɪ",
    "minute": "ˈmɪnət", "second": "ˈsɛkənd", "first": "fərst",
    "third": "θərd", "half": "hæf", "quarter": "ˈkwɔrtər",
    "colonel": "ˈkərnəl", "receipt": "rɪˈsit", "iron": "ˈaɪərn",
    "sword": "sɔrd", "castle": "ˈkæsəl", "listen": "ˈlɪsən",
    "christmas": "ˈkrɪsməs", "wednesday": "ˈwɛnzdeɪ", "february": "ˈfɛbjəˌwɛri",
    "comfortable": "ˈkəmfərtəbəl", "vegetable": "ˈvɛʤtəbəl",
    "interesting": "ˈɪntrəstɪŋ", "different": "ˈdɪfərənt",
    "restaurant": "ˈrɛstəˌrɑnt", "chocolate": "ˈʧɔklət",
    "stomach": "ˈstəmək", "ache": "eɪk", "character": "ˈkɛrɪktər",
    "chorus": "ˈkɔrəs", "echo": "ˈɛkoʊ", "school": "skul",
    "chemistry": "ˈkɛməstri", "christ": "kraɪst", "chrome": "kroʊm",
    "one's": "wənz", "ones": "wənz", "says'": "sɛz",
    "hello": "həˈloʊ", "yeah": "jɛə", "okay": "ˌoʊˈkeɪ",
}


def register_lexicon(entries: dict[str, str]) -> None:
    """Merge an external word→IPA lexicon (e.g. converted CMUdict)."""
    _LEXICON.update({k.lower(): v for k, v in entries.items()})


# frequency-lexicon data module (text/en_lexicon.py): ~900 common words in
# eng_to_ipa conventions so everyday vocabulary bypasses the rule engine —
# the inline table above keeps priority for its hand-checked entries
from ovbench.reference.text.en_lexicon import LEXICON as _FREQ_LEXICON  # noqa: E402

for _w, _p in _FREQ_LEXICON.items():
    _LEXICON.setdefault(_w, _p)
del _w, _p


# ---------------------------------------------------------------------------
# G2P: NRL-style letter-to-sound rules (fallback for out-of-lexicon words)
#
# Rule: (left, grapheme, right, phonemes) with context specials:
#   '#' one or more vowels, ':' zero or more consonants, '^' one consonant,
#   '.' one voiced consonant, '%' suffix (e|er|es|ed|ing|ely), '+' front
#   vowel (e|i|y), ' ' word boundary.  First match wins; longest grapheme
#   rules come first per letter.
# ---------------------------------------------------------------------------

_RULES: dict[str, list[tuple[str, str, str, str]]] = {
    "a": [
        (" ", "are", " ", "ɑr"), (" ", "ar", "o", "əˈr"), ("", "ar", "#", "ɛr"),
        ("^", "as", "#", "eɪs"), ("", "a", "wa", "ə"), ("", "aw", "", "ɔ"),
        (" :", "any", "", "ˈɛni"), ("", "a", "^+#", "eɪ"), ("#:", "ally", "", "əli"),
        (" ", "al", "#", "əl"), ("", "again", "", "əˈgɛn"), ("#:", "ag", "e", "ɪʤ"),
        ("", "a", "^+:#", "æ"), (" :", "a", "^+ ", "eɪ"), ("", "a", "^%", "eɪ"),
        (" ", "arr", "", "əˈr"), ("", "arr", "", "ær"), (" :", "ar", " ", "ɑr"),
        ("", "ar", " ", "ər"), ("", "ar", "", "ɑr"), ("", "air", "", "ɛr"),
        ("", "ai", "", "eɪ"), ("", "ay", "", "eɪ"), ("", "au", "", "ɔ"),
        ("#:", "al", " ", "əl"), ("#:", "als", " ", "əlz"), ("", "alk", "", "ɔk"),
        ("", "al", "^", "ɔl"), (" :", "able", "", "ˈeɪbəl"), ("", "able", "", "əbəl"),
        ("", "ang", "+", "eɪnʤ"),
        # word-final 'a' is the unstressed reduced vowel (sofa, russia,
        # vanilla — CMU): measured on the lexicon this corrects 90 words
        # and regresses 4 loanwords (spa-class), benchmarks/measure_g2p_per.py
        ("", "a", " ", "ə"),
        ("", "a", "", "æ"),
    ],
    "b": [
        (" ", "be", "^#", "bɪ"), ("", "being", "", "ˈbiɪŋ"), (" ", "both", " ", "boʊθ"),
        (" ", "bus", "#", "bɪz"), ("", "buil", "", "bɪl"), ("", "b", "", "b"),
    ],
    "c": [
        (" ", "ch", "^", "k"), ("^e", "ch", "", "k"), ("", "ch", "", "ʧ"),
        (" s", "ci", "#", "saɪ"), ("", "ci", "a", "ʃ"), ("", "ci", "o", "ʃ"),
        ("", "ci", "en", "ʃ"), ("", "c", "+", "s"), ("", "ck", "", "k"),
        ("", "com", "%", "kəm"), ("", "c", "", "k"),
    ],
    "d": [
        ("#:", "ded", " ", "dɪd"), (".e", "d", " ", "d"), ("#:^e", "d", " ", "t"),
        (" ", "de", "^#", "dɪ"), (" ", "do", " ", "du"), (" ", "does", "", "dəz"),
        (" ", "doing", "", "ˈduɪŋ"), (" ", "dow", "", "daʊ"), ("", "du", "a", "ʤu"),
        ("", "d", "", "d"),
    ],
    "e": [
        ("#:", "e", " ", ""), ("':^", "e", " ", ""), (" :", "e", " ", "i"),
        ("#", "ed", " ", "d"), ("#:", "e", "d ", ""), ("", "ev", "er", "ˈɛv"),
        ("", "e", "^%", "i"), ("", "eri", "#", "ˈiri"), ("", "eri", "", "ˈɛrɪ"),
        ("#:", "er", "#", "ər"), ("", "er", "#", "ˈɛr"), ("", "er", "", "ər"),
        (" ", "even", "", "ˈivɛn"), ("#:", "e", "w", ""), ("t", "ew", "", "u"),
        ("s", "ew", "", "u"), ("r", "ew", "", "u"), ("d", "ew", "", "u"),
        ("l", "ew", "", "u"), ("z", "ew", "", "u"), ("n", "ew", "", "u"),
        ("j", "ew", "", "u"), ("th", "ew", "", "u"), ("ch", "ew", "", "u"),
        ("sh", "ew", "", "u"), ("", "ew", "", "ju"), ("", "e", "o", "i"),
        ("#:s", "es", " ", "ɪz"), ("#:c", "es", " ", "ɪz"), ("#:g", "es", " ", "ɪz"),
        ("#:z", "es", " ", "ɪz"), ("#:x", "es", " ", "ɪz"), ("#:j", "es", " ", "ɪz"),
        ("#:ch", "es", " ", "ɪz"), ("#:sh", "es", " ", "ɪz"), ("#:", "e", "s ", ""),
        ("", "ely", " ", "li"), ("", "ement", "", "mɛnt"), ("", "eful", "", "fʊl"),
        ("", "ee", "", "i"), ("", "earn", "", "ərn"), (" ", "ear", "^", "ər"),
        ("", "ead", "", "ɛd"), ("#:", "ea", " ", "iə"), ("", "ea", "su", "ɛ"),
        ("", "ea", "", "i"), ("", "eigh", "", "eɪ"), ("", "ei", "", "i"),
        (" ", "eye", "", "aɪ"), ("", "ey", "", "i"), ("", "eu", "", "ju"),
        ("", "e", "", "ɛ"),
    ],
    "f": [("", "ful", "", "fʊl"), ("", "f", "", "f")],
    "g": [
        ("", "giv", "", "gɪv"), (" ", "g", "i^", "g"), ("", "ge", "t", "gɛ"),
        ("su", "gges", "", "gˈʤɛs"), ("", "gg", "", "g"), (" b#", "g", "", "g"),
        ("", "g", "+", "ʤ"), ("", "great", "", "greɪt"), ("#", "gh", "", ""),
        ("", "g", "", "g"),
    ],
    "h": [
        (" ", "hav", "", "hæv"), (" ", "here", "", "hir"), (" ", "hour", "", "aʊər"),
        ("", "how", "", "haʊ"), ("", "h", "#", "h"), ("", "h", "", ""),
    ],
    "i": [
        (" ", "in", "", "ɪn"), (" ", "i", " ", "aɪ"), ("", "in", "d", "aɪn"),
        ("", "ier", "", "iər"), ("#:r", "ied", "", "id"), ("", "ied", " ", "aɪd"),
        ("", "ien", "", "iɛn"), ("", "ie", "t", "aɪɛ"), (" :", "i", "%", "aɪ"),
        ("", "i", "%", "i"), ("", "ie", "", "i"), ("", "i", "^+:#", "ɪ"),
        ("", "ir", "#", "aɪr"), ("", "iz", "%", "aɪz"), ("", "is", "%", "aɪz"),
        ("", "i", "d%", "aɪ"), ("+^", "i", "^+", "ɪ"), ("", "i", "t%", "aɪ"),
        ("#:^", "i", "^+", "ɪ"), ("", "i", "^+", "aɪ"), ("", "ir", "", "ər"),
        ("", "igh", "", "aɪ"), ("", "ild", "", "aɪld"), ("", "ign", " ", "aɪn"),
        ("", "ign", "^", "aɪn"), ("", "ign", "%", "aɪn"), ("", "ique", "", "ik"),
        ("", "i", "", "ɪ"),
    ],
    "j": [("", "j", "", "ʤ")],
    "k": [(" ", "k", "n", ""), ("", "k", "", "k")],
    "l": [
        ("", "lo", "c#", "loʊ"), ("l", "l", "", ""), ("#:^", "l", "%", "əl"),
        (" ", "lead", "", "lid"), ("", "l", "", "l"),
    ],
    "m": [("", "mov", "", "muv"), ("", "m", "", "m")],
    "n": [
        ("e", "ng", "+", "nʤ"), ("", "ng", "r", "ŋg"), ("", "ng", "#", "ŋg"),
        ("", "ngl", "%", "ŋgəl"), ("", "ng", "", "ŋ"), ("", "nk", "", "ŋk"),
        (" ", "now", " ", "naʊ"), ("", "n", "", "n"),
    ],
    "o": [
        ("", "of", " ", "əv"), (" ", "org", "", "ɔrg"), (" ", "or", " ", "ɔr"),
        ("#:", "or", " ", "ər"), ("#:", "ors", " ", "ərz"), ("", "or", "", "ɔr"),
        (" ", "one", "", "wən"), ("", "ow", "", "oʊ"), (" ", "over", "", "ˈoʊvər"),
        ("", "ov", "", "əv"), ("", "o", "^%", "oʊ"), ("", "o", "^en", "oʊ"),
        ("", "o", "^i#", "oʊ"), ("", "ol", "d", "oʊl"), ("", "ought", "", "ɔt"),
        ("", "ough", "", "əf"), (" ", "ou", "", "aʊ"), ("h", "ou", "s#", "aʊ"),
        ("", "ous", "", "əs"), ("", "our", "", "ɔr"), ("", "ould", "", "ʊd"),
        ("^", "ou", "^l", "ə"), ("", "oup", "", "up"), ("", "ou", "", "aʊ"),
        ("", "oy", "", "ɔɪ"), ("", "oing", "", "oʊɪŋ"), ("", "oi", "", "ɔɪ"),
        ("", "oor", "", "ɔr"), ("", "ook", "", "ʊk"), ("", "ood", "", "ʊd"),
        ("", "oo", "", "u"), ("", "o", "e", "oʊ"), ("", "o", " ", "oʊ"),
        ("", "oa", "", "oʊ"), (" ", "only", "", "ˈoʊnli"), (" ", "once", "", "wəns"),
        ("", "on't", "", "oʊnt"), ("c", "o", "n", "ɑ"), ("", "o", "ng", "ɔ"),
        (" :^", "o", "n", "ə"), ("i", "on", "", "ən"), ("#:", "on", " ", "ən"),
        ("#^", "on", "", "ən"), ("", "o", "st ", "oʊ"), ("", "of", "^", "ɔf"),
        ("", "other", "", "ˈəðər"), ("", "oss", " ", "ɔs"), ("#:^", "om", "", "əm"),
        ("", "o", "", "ɑ"),
    ],
    "p": [("", "ph", "", "f"), ("", "peop", "", "pip"), ("", "pow", "", "paʊ"),
          ("", "put", " ", "pʊt"), ("", "p", "", "p")],
    "q": [("", "quar", "", "kwɔr"), ("", "qu", "", "kw"), ("", "q", "", "k")],
    "r": [(" ", "re", "^#", "ri"), ("", "r", "", "r")],
    "s": [
        ("", "sh", "", "ʃ"), ("#", "sion", "", "ʒən"), ("", "some", "", "səm"),
        ("#", "sur", "#", "ʒər"), ("", "sur", "#", "ʃər"), ("#", "su", "#", "ʒu"),
        ("#", "ssu", "#", "ʃu"), ("#", "sed", " ", "zd"), ("#", "s", "#", "z"),
        ("", "said", "", "sɛd"), ("^", "sion", "", "ʃən"), ("", "s", "s", ""),
        (".", "s", " ", "z"), ("#:.e", "s", " ", "z"), ("#:^##", "s", " ", "z"),
        ("#:^#", "s", " ", "s"), ("u", "s", " ", "s"), (" :#", "s", " ", "z"),
        (" ", "sch", "", "sk"), ("", "s", "c+", ""), ("#", "sm", "", "zm"),
        ("#", "sn", "'", "zən"), ("", "s", "", "s"),
    ],
    "t": [
        (" ", "the", " ", "ðə"), ("", "to", " ", "tu"), ("", "that", " ", "ðæt"),
        (" ", "this", " ", "ðɪs"), (" ", "they", "", "ðeɪ"), (" ", "there", "", "ðɛr"),
        ("", "ther", "", "ðər"), ("", "their", "", "ðɛr"), (" ", "than", " ", "ðæn"),
        (" ", "them", " ", "ðɛm"), ("", "these", " ", "ðiz"), (" ", "then", "", "ðɛn"),
        ("", "through", "", "θru"), ("", "those", "", "ðoʊz"), ("", "though", " ", "ðoʊ"),
        (" ", "thus", "", "ðəs"), ("", "th", "", "θ"), ("#:", "ted", " ", "tɪd"),
        ("s", "ti", "#n", "ʧ"), ("", "ti", "o", "ʃ"), ("", "ti", "a", "ʃ"),
        ("", "tien", "", "ʃən"), ("", "tur", "#", "ʧər"), ("", "tu", "a", "ʧu"),
        (" ", "two", "", "tu"), ("", "t", "", "t"),
    ],
    "u": [
        (" ", "un", "i", "jun"), (" ", "un", "", "ən"), (" ", "upon", "", "əˈpɔn"),
        ("t", "ur", "#", "ʊr"), ("s", "ur", "#", "ʊr"), ("r", "ur", "#", "ʊr"),
        ("d", "ur", "#", "ʊr"), ("l", "ur", "#", "ʊr"), ("z", "ur", "#", "ʊr"),
        ("n", "ur", "#", "ʊr"), ("j", "ur", "#", "ʊr"), ("th", "ur", "#", "ʊr"),
        ("ch", "ur", "#", "ʊr"), ("sh", "ur", "#", "ʊr"), ("", "ur", "#", "jʊr"),
        ("", "ur", "", "ər"), ("", "u", "^ ", "ə"), ("", "u", "^^", "ə"),
        ("", "uy", "", "aɪ"), (" g", "u", "#", ""), ("g", "u", "%", ""),
        ("g", "u", "#", "w"), ("#n", "u", "", "ju"), ("t", "u", "", "u"),
        ("s", "u", "", "u"), ("r", "u", "", "u"), ("d", "u", "", "u"),
        ("l", "u", "", "u"), ("z", "u", "", "u"), ("n", "u", "", "u"),
        ("j", "u", "", "u"), ("th", "u", "", "u"), ("ch", "u", "", "u"),
        ("sh", "u", "", "u"), ("", "u", "", "ju"),
    ],
    "v": [("", "view", "", "vju"), ("", "v", "", "v")],
    "w": [
        (" ", "were", "", "wər"), ("", "wa", "s", "wɑ"), ("", "wa", "t", "wɑ"),
        ("", "where", "", "wɛr"), ("", "what", "", "wət"), ("", "whol", "", "hoʊl"),
        ("", "who", "", "hu"), ("", "wh", "", "w"), ("", "war", "", "wɔr"),
        ("", "wor", "^", "wər"), ("", "wr", "", "r"), ("", "w", "", "w"),
    ],
    "x": [(" ", "x", "", "z"), ("", "x", "", "ks")],
    "y": [
        ("", "young", "", "jəŋ"), (" ", "you", "", "ju"), (" ", "yes", "", "jɛs"),
        (" ", "y", "", "j"), ("#:^", "y", " ", "i"), ("#:^", "y", "i", "i"),
        (" :", "y", " ", "aɪ"), (" :", "y", "#", "aɪ"), (" :", "y", "^+:#", "ɪ"),
        (" :", "y", "^#", "aɪ"), ("", "y", "", "ɪ"),
    ],
    "z": [("", "z", "", "z")],
    "'": [("#:^", "'s", " ", "z"), ("#", "'s", " ", "z"), ("", "'", "", "")],
}

_VOWELS = "aeiou"
_FRONT = "eiy"
_CONSONANTS = "bcdfghjklmnpqrstvwxz"
_VOICED = "bdvgjlmnrwz"


def _match_left(pattern: str, text: str, pos: int) -> bool:
    """Match `pattern` (reversed scan) against text ending at pos (exclusive)."""
    i = pos
    for ch in reversed(pattern):
        if ch == "#":
            if i <= 0 or text[i - 1] not in _VOWELS:
                return False
            i -= 1
            while i > 0 and text[i - 1] in _VOWELS:
                i -= 1
        elif ch == ":":
            while i > 0 and text[i - 1] in _CONSONANTS:
                i -= 1
        elif ch == "^":
            if i <= 0 or text[i - 1] not in _CONSONANTS:
                return False
            i -= 1
        elif ch == ".":
            if i <= 0 or text[i - 1] not in _VOICED:
                return False
            i -= 1
        elif ch == "+":
            if i <= 0 or text[i - 1] not in _FRONT:
                return False
            i -= 1
        elif ch == " ":
            if i > 0:
                return False
        else:
            if i <= 0 or text[i - 1] != ch:
                return False
            i -= 1
    return True


def _match_right(pattern: str, text: str, pos: int) -> bool:
    i = pos
    n = len(text)
    for j, ch in enumerate(pattern):
        if ch == "#":
            if i >= n or text[i] not in _VOWELS:
                return False
            i += 1
            while i < n and text[i] in _VOWELS:
                i += 1
        elif ch == ":":
            while i < n and text[i] in _CONSONANTS:
                i += 1
        elif ch == "^":
            if i >= n or text[i] not in _CONSONANTS:
                return False
            i += 1
        elif ch == ".":
            if i >= n or text[i] not in _VOICED:
                return False
            i += 1
        elif ch == "+":
            if i >= n or text[i] not in _FRONT:
                return False
            i += 1
        elif ch == "%":
            rest = text[i:]
            for suf in ("ely", "ing", "er", "es", "ed", "e"):
                if rest.startswith(suf):
                    i += len(suf)
                    break
            else:
                return False
        elif ch == " ":
            if i < n:
                return False
        else:
            if i >= n or text[i] != ch:
                return False
            i += 1
    return True


def word_to_ipa_rules(word: str) -> str:
    """Letter-to-sound: NRL-style first-match-wins scan."""
    out = []
    i = 0
    n = len(word)
    while i < n:
        ch = word[i]
        rules = _RULES.get(ch)
        if rules is None:
            i += 1
            continue
        for left, graph, right, phon in rules:
            if not word.startswith(graph, i):
                continue
            if not _match_left(left, word, i):
                continue
            if not _match_right(right, word, i + len(graph)):
                continue
            out.append(phon)
            i += len(graph)
            break
        else:
            i += 1
    return "".join(out)


def _lexicon_base(word: str, suf: str) -> str | None:
    """Base-form lexicon pronunciation for `word` = base + `suf`, covering
    regular spelling changes: silent-e drop (arrive→arrived, wave→waving),
    y→ie (study→studies/studied), final-consonant doubling (chop→chopping)."""
    stem = word[: -len(suf)]
    # un-doubled VC+ed/ing/es spellings come from the silent-e base in
    # English orthography (striped←stripe, planed←plane); the bare stem's
    # own inflection doubles the consonant and is handled below — so when
    # both bases exist, the silent-e base wins (advisor r3)
    if suf in ("ed", "ing", "es"):
        if stem + "e" in _LEXICON:  # silent-e base: arrived, waving, boxes? no — es keeps stem
            return _LEXICON[stem + "e"]
        if len(stem) >= 2 and stem[-1] == stem[-2] and stem[:-1] in _LEXICON:
            return _LEXICON[stem[:-1]]  # doubled consonant: chopping, begged
    if stem in _LEXICON:
        return _LEXICON[stem]
    return None


# common contractions (CMUdict carries these as words; the rule engine
# mangles the apostrophe forms)
_CONTRACTIONS: dict[str, str] = {
    "don't": "doʊnt", "doesn't": "ˈdəzənt", "didn't": "ˈdɪdənt",
    "can't": "kænt", "won't": "woʊnt", "isn't": "ˈɪzənt",
    "aren't": "ˈɑrənt", "wasn't": "ˈwəzənt", "weren't": "ˈwərənt",
    "haven't": "ˈhævənt", "hasn't": "ˈhæzənt", "hadn't": "ˈhædənt",
    "couldn't": "ˈkʊdənt", "shouldn't": "ˈʃʊdənt", "wouldn't": "ˈwʊdənt",
    "it's": "ɪts", "that's": "ðæts", "there's": "ðɛrz", "what's": "wəts",
    "let's": "lɛts", "i'm": "aɪm", "i've": "aɪv", "i'll": "aɪl",
    "i'd": "aɪd", "you're": "jʊr", "you've": "juv", "you'll": "jul",
    "you'd": "jud", "we're": "wir", "we've": "wiv", "we'll": "wil",
    "we'd": "wid", "they're": "ðɛr", "they've": "ðeɪv", "they'll": "ðeɪl",
    "they'd": "ðeɪd", "he's": "hiz", "she's": "ʃiz", "he'll": "hil",
    "she'll": "ʃil", "he'd": "hid", "she'd": "ʃid", "who's": "huz",
    "here's": "hɪrz", "ain't": "eɪnt",
}


def lexicon_pron(word: str) -> str | None:
    """CMU-convention pronunciation from the lexicon (directly or through
    regular morphology), or None when only the rule engine could serve the
    word.  The coverage tests measure exactly this predicate."""
    if word in _LEXICON:
        return _LEXICON[word]
    if word in _CONTRACTIONS:
        return _CONTRACTIONS[word]
    # regular morphology via base-form lexicon hits (matches eng_to_ipa
    # because CMUdict pronounces inflected forms exactly this way)
    if word.endswith("ies") and word[:-3] + "y" in _LEXICON:
        return _LEXICON[word[:-3] + "y"] + "z"  # study→studies: i-final, +z
    if word.endswith("ied") and word[:-3] + "y" in _LEXICON:
        return _LEXICON[word[:-3] + "y"] + "d"
    # comparative/agentive -er(s), superlative -est (CMUdict pronounces
    # these regularly: older = oʊld + ər, researchers = rɪˈsərʧ + ərz)
    for suf, tail in (("ers", "ərz"), ("er", "ər"), ("est", "əst")):
        if not word.endswith(suf):
            continue
        # a direct lexicon entry for the -er form outranks the er-derivation
        # (flowers = flower+z, not flow+ərz); fall through to the plural path
        if suf == "ers" and word[:-1] in _LEXICON:
            continue
        stem = word[: -len(suf)]
        base = _LEXICON.get(stem)
        if base is None and (stem + "e") in _LEXICON:  # large→larger
            base = _LEXICON[stem + "e"]
        if base is None and len(stem) >= 2 and stem[-1] == stem[-2] \
                and stem[:-1] in _LEXICON:  # big→bigger
            base = _LEXICON[stem[:-1]]
        if base is not None:
            if "ˈ" not in base and "ˌ" not in base:
                return "ˈ" + base + tail
            return base + tail
    # adverbial -ly on a lexicon base (CMUdict pronounces these regularly:
    # quickly = kwɪk + li, correctly = kərˈɛkt + li, solely = soʊl + li)
    if word.endswith("ly") and len(word) > 4:
        base = _LEXICON.get(word[:-2])
        if base is not None:
            if base.endswith("əl"):
                # -ally collapses to a single l (manually = ˈmænjuəli,
                # finally = ˈfaɪnəli — CMU), unlike stressed-l bases
                # (solely = soʊlli)
                tail = base[:-1] + "li"
            else:
                tail = base + "li"
            if "ˈ" not in tail and "ˌ" not in tail:
                return "ˈ" + tail
            return tail
    if word.endswith("'s") and word[:-2] in _LEXICON:  # possessive
        base = _LEXICON[word[:-2]]
        last = base[-1]
        if last in "szʃʒʧʤ":
            return base + "ɪz"
        return base + ("s" if last in "ptkfθ" else "z")
    for suf in ("s", "es", "ed", "ing"):
        if not word.endswith(suf):
            continue
        base = _lexicon_base(word, suf)
        if base is None:
            continue
        def syllabic(p: str) -> str:
            # a monosyllabic base carries no stress mark; once the suffix
            # adds a syllable, eng_to_ipa marks primary stress on the base
            if "ˈ" not in base and "ˌ" not in base:
                return "ˈ" + base + p
            return base + p

        if suf in ("s", "es"):
            last = base[-1]
            if last in "szʃʒʧʤ":
                return syllabic("ɪz")
            if last in "ptkfθ":
                return base + "s"
            return base + "z"
        if suf == "ed":
            last = base[-1]
            if last in "td":
                return syllabic("ɪd")
            if last in "pkfsθʃʧ":
                return base + "t"
            return base + "d"
        return syllabic("ɪŋ")
    return None


def word_to_ipa(word: str) -> str:
    pron = lexicon_pron(word)
    return pron if pron is not None else word_to_ipa_rules(word)


_DIPHTHONGS = ("aɪ", "eɪ", "oʊ", "aʊ", "ɔɪ")


def phoneme_tokens(ipa: str) -> list[str]:
    """Segment an IPA string (this module's CMU-convention inventory) into
    phoneme tokens for error-rate scoring: stress marks are dropped, the
    five diphthongs are single tokens (bare a/e/o occur ONLY inside them in
    this convention — the monophthongs are ɑ/ɛ/ɔ), everything else is one
    codepoint (ʧ/ʤ are single codepoints here).  Used by the rule-engine
    PER measurement (benchmarks/measure_g2p_per.py, tests/test_text.py)."""
    out: list[str] = []
    i = 0
    while i < len(ipa):
        if ipa[i] in "ˈˌ":
            i += 1
            continue
        pair = ipa[i : i + 2]
        if pair in _DIPHTHONGS:
            out.append(pair)
            i += 2
        else:
            out.append(ipa[i])
            i += 1
    return out


def english_to_ipa(text: str) -> str:
    """normalize + per-word G2P (reference english_to_ipa, english.py:160-166)."""
    text = normalize_english(text)
    parts = re.findall(r"[a-z']+|[^a-z'\s]+|\s+", text)
    out = []
    for p in parts:
        if re.fullmatch(r"[a-z']+", p):
            out.append(word_to_ipa(p))
        else:
            out.append(p)
    return collapse_whitespace("".join(out))


def mark_dark_l(text: str) -> str:
    """l → ɫ before non-vowel (reference english.py:156-157)."""
    return re.sub(r"l([^aeiouæɑɔəɛɪʊ ]*(?: |$))", lambda m: "ɫ" + m.group(1), text)


_IPA_TO_IPA2 = [("r", "ɹ"), ("ʤ", "dʒ"), ("ʧ", "tʃ")]


def english_to_ipa2(text: str) -> str:
    """The V1 frontend's English target representation (english.py:176-181)."""
    text = english_to_ipa(text)
    text = mark_dark_l(text)
    for a, b in _IPA_TO_IPA2:
        text = text.replace(a, b)
    return text.replace("...", "…")


_LAZY_IPA2 = [("r", "ɹ"), ("ð", "z"), ("θ", "s"), ("ʒ", "ʑ"), ("ʤ", "dʑ"), ("ˈ", "↓")]


def english_to_lazy_ipa2(text: str) -> str:
    text = english_to_ipa(text)
    for a, b in _LAZY_IPA2:
        text = text.replace(a, b)
    return text
