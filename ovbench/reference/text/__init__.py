"""The English text front end of the reference: text → sentences → IPA →
token ids, as OpenVoice's V1 base-speaker TTS reads English (reference
repository: openvoice/text/__init__.py, cleaners.py, symbols.py, and
utils.py's sentence splitter).

`english.py`, `en_lexicon.py`, `symbols.py` and `split.py` are frozen copies
of the PyTorch port's, which reimplement the reference's ``eng_to_ipa``-based
G2P without its external lexicon.  Departure: `cjke_cleaners2` handles the
``[EN]`` spans only; the benchmark's traffic is English.
"""

from __future__ import annotations

import re

from ovbench.reference.text.english import english_to_ipa2
from ovbench.reference.text.split import split_sentence
from ovbench.reference.text.symbols import symbols as default_symbols


def cjke_cleaners2(text: str) -> str:
    """``[EN]…[EN]`` spans → IPA, then the reference's final punctuation."""
    text = re.sub(r"\[EN\](.*?)\[EN\]", lambda m: english_to_ipa2(m.group(1)) + " ", text)
    text = re.sub(r"\s+$", "", text)
    return re.sub(r"([^\.,!\?\-…~])$", r"\1.", text)


def text_to_sequence(text: str, symbols=default_symbols) -> list[int]:
    """Cleaned text → symbol ids, silently dropping symbols outside the
    inventory (the trained checkpoints' contract)."""
    symbol_to_id = {s: i for i, s in enumerate(symbols)}
    return [symbol_to_id[ch] for ch in cjke_cleaners2(text) if ch in symbol_to_id]


def intersperse(seq: list[int], item: int = 0) -> list[int]:
    """Blank-token interleave: [a, b] → [0, a, 0, b, 0]."""
    result = [item] * (len(seq) * 2 + 1)
    result[1::2] = seq
    return result


def english_tokens(text: str, add_blank: bool = True) -> list[list[int]]:
    """OpenVoice's V1 English path: split into sentences, split camel case,
    tag ``[EN]``, clean, map to ids, intersperse blanks; one id list a
    sentence."""
    out = []
    for sentence in split_sentence(text, language_str="EN"):
        sentence = re.sub(r"([a-z])([A-Z])", r"\1 \2", sentence)
        seq = text_to_sequence(f"[EN]{sentence}[EN]")
        out.append(intersperse(seq, 0) if add_blank else seq)
    return out
