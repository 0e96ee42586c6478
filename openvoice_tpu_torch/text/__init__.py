"""Text frontend: cleaners → IPA → token IDs (reference: openvoice/text/).

Host-side, CPU-only.  `text_to_sequence` preserves the reference's tokenizer
contract exactly (text/__init__.py:11-30): run cleaners, then map characters
to symbol IDs, silently dropping characters outside the symbol set — that
silent drop is checkpoint-defining behavior, so it is kept.
"""

from __future__ import annotations

from openvoice_tpu_torch.text.symbols import symbols as default_symbols  # noqa: F401
from openvoice_tpu_torch.text import cleaners as _cleaners_mod


def _clean_text(text: str, cleaner_names) -> str:
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def text_to_sequence(text: str, symbols, cleaner_names) -> list[int]:
    """Text → list of symbol IDs (drops unknown symbols, reference parity)."""
    symbol_to_id = {s: i for i, s in enumerate(symbols)}
    clean = _clean_text(text, cleaner_names)
    return [symbol_to_id[ch] for ch in clean if ch in symbol_to_id]


def cleaned_text_to_sequence(cleaned_text: str, symbols) -> list[int]:
    symbol_to_id = {s: i for i, s in enumerate(symbols)}
    return [symbol_to_id[ch] for ch in cleaned_text if ch in symbol_to_id]


def cleaned_text_to_sequence_vits2(
    cleaned_text, tones, language: str, symbols, languages
) -> tuple[list[int], list[int], list[int]]:
    """VITS2-style tokenization with tone and language IDs
    (reference text/__init__.py:47-61, unused by the shipped checkpoints but
    part of the frontend surface): phone IDs, per-language tone offsets from
    symbols.language_tone_start_map, and a constant language-ID stream."""
    from openvoice_tpu_torch.text.symbols import language_tone_start_map

    symbol_to_id = {s: i for i, s in enumerate(symbols)}
    language_id_map = {s: i for i, s in enumerate(languages)}
    phones = [symbol_to_id[ch] for ch in cleaned_text]
    tone_start = language_tone_start_map[language]
    tones = [t + tone_start for t in tones]
    lang_ids = [language_id_map[language]] * len(phones)
    return phones, tones, lang_ids


def sequence_to_text(sequence, symbols=None) -> str:
    symbols = symbols if symbols is not None else default_symbols
    id_to_symbol = {i: s for i, s in enumerate(symbols)}
    return "".join(id_to_symbol[i] for i in sequence if i in id_to_symbol)


def intersperse(seq: list[int], item: int = 0) -> list[int]:
    """Blank-token interleave (commons.py:22-25): [a,b] → [0,a,0,b,0]."""
    result = [item] * (len(seq) * 2 + 1)
    result[1::2] = seq
    return result
