"""Sentence splitting for TTS batching (reference: utils.py:78-194).

Latin text splits on punctuation then regroups to ≥~10 words; Chinese
regroups by character count; short trailing pieces merge backward.  Behavior
matches the reference so the same text yields the same segment boundaries
(segment boundaries are audible — they insert 0.05 s gaps).
"""

from __future__ import annotations

import re


def split_sentence(text: str, min_len: int = 10, language_str: str = "EN") -> list[str]:
    """EN and KO split on words (space-delimited scripts); ZH and JA regroup
    by character count (reference: utils.py:78-83 routes only EN vs ZH —
    JA/KO routing is ours, since the reference's JA/KO path never worked)."""
    if language_str in ("EN", "[EN]", "KO", "[KO]"):
        return _split_latin(text, min_len)
    return _split_zh(text, min_len)


def _clean_common(text: str) -> str:
    text = re.sub("[。！？;]", ".", text)
    text = re.sub("[，]", ",", text)
    text = re.sub("[\n\t ]+", " ", text)
    text = re.sub(r"([,.!?;])", r"\1 $#!", text)
    return text


def _split_latin(text: str, min_len: int) -> list[str]:
    text = re.sub("[。！？；]", ".", text)
    text = re.sub("[，]", ",", text)
    text = re.sub("[“”]", '"', text)
    text = re.sub("[‘’]", "'", text)
    text = re.sub(r"[\<\>\(\)\[\]\"\«\»]+", "", text)
    text = re.sub("[\n\t ]+", " ", text)
    text = re.sub(r"([,.!?;])", r"\1 $#!", text)
    sentences = [s.strip() for s in text.split("$#!")]
    if sentences and len(sentences[-1]) == 0:
        del sentences[-1]

    grouped: list[str] = []
    cur: list[str] = []
    count = 0
    for ind, sent in enumerate(sentences):
        cur.append(sent)
        count += len(sent.split(" "))
        if count > min_len or ind == len(sentences) - 1:
            count = 0
            grouped.append(" ".join(cur))
            cur = []
    return _merge_short(grouped, lambda s: len(s.split(" ")))


def _split_zh(text: str, min_len: int) -> list[str]:
    text = _clean_common(text)
    sentences = [s.strip() for s in text.split("$#!")]
    if sentences and len(sentences[-1]) == 0:
        del sentences[-1]

    grouped: list[str] = []
    cur: list[str] = []
    count = 0
    for ind, sent in enumerate(sentences):
        cur.append(sent)
        count += len(sent)
        if count > min_len or ind == len(sentences) - 1:
            count = 0
            grouped.append(" ".join(cur))
            cur = []
    return _merge_short(grouped, len)


def _merge_short(sens: list[str], size) -> list[str]:
    out: list[str] = []
    for s in sens:
        if out and size(out[-1]) <= 2:
            out[-1] = out[-1] + " " + s
        else:
            out.append(s)
    if len(out) >= 2 and size(out[-1]) <= 2:
        out[-2] = out[-2] + " " + out[-1]
        out.pop(-1)
    return out
