"""MeloTTS's English text side (melo/utils.py::get_text_for_tts_infer,
melo/text/english.py::g2p, melo/split_utils.py), built on the port's English
front end.

What the port keeps of MeloTTS: the sentence split (`split_pieces`,
txtsplit with a desired length of 256 characters and a limit of 512), the
phone, tone and language streams with a pad phone at each end, the blank
interleave (phones, tones and languages interspersed with 0, ``word2ph``
doubled with one more on its first entry), and the wordpieces' [CLS] and
[SEP] with one phone each.

Stand-ins, for MeloTTS's data files that this repository does not hold (its
symbol table, cmudict and g2p_en, and bert-base-uncased's ``vocab.txt``):

* phones come from the port's English G2P (``text/english.py``: its lexicon
  and letter-to-sound rules), split into phonemes as ``phoneme_tokens``
  splits them, in place of MeloTTS's ARPAbet;
* tones come from the IPA stress marks: a vowel takes tone 1, or 2 after a
  primary and 3 after a secondary stress mark (ARPAbet's stress digit + 1,
  as melo/text/english.py's ``refine_ph``), a consonant or a punctuation
  mark 0; then each is offset by ``language_tone_start_map["EN"]``;
* a phone's id is a fixed hash of the phone into rows 1 … n_vocab − 1 of the
  table (row 0 is the pad and the blank);
* a word or punctuation mark is one wordpiece, a fixed hash into the
  vocabulary's whole-word rows (from 1996 on), between [CLS] (101) and
  [SEP] (102); WordPiece would split rare words further.
"""

from __future__ import annotations

import re
import zlib
from typing import NamedTuple

import numpy as np

from openvoice_tpu_torch.text.english import normalize_english, word_to_ipa
from openvoice_tpu_torch.text.symbols import language_tone_start_map

EN_LANGUAGE_ID = 2          # melo/text/symbols.py language_id_map["EN"]
CLS_ID, SEP_ID = 101, 102   # bert-base-uncased's [CLS] and [SEP]
WORDPIECE_FIRST = 1996      # its first whole-word row
_DIPHTHONGS = ("aɪ", "eɪ", "oʊ", "aʊ", "ɔɪ")
_VOWELS = set("aeiouæɑɔəɛɪʊʌɜɚ")
_STRESS_TONE = {"ˈ": 2, "ˌ": 3}


class MeloTokens(NamedTuple):
    """One sentence's inputs of MeloTTS's text encoder and BERT, blanks
    interspersed: int32 arrays."""

    phones: np.ndarray      # [T]
    tones: np.ndarray       # [T]
    languages: np.ndarray   # [T]
    wordpieces: np.ndarray  # [W]: [CLS] … [SEP]
    word2ph: np.ndarray     # [W]: each wordpiece's phones; sums to T


def _hash(text: str, first: int, rows: int) -> int:
    return first + zlib.crc32(text.encode("utf-8")) % rows


def word_phones(word: str) -> tuple[list[str], list[int]]:
    """A lowercase word → (phonemes, tones before the language's offset)."""
    ipa = word_to_ipa(word)
    phones, tones, stress, i = [], [], 0, 0
    while i < len(ipa):
        if ipa[i] in _STRESS_TONE:
            stress = _STRESS_TONE[ipa[i]]
            i += 1
            continue
        ph = ipa[i : i + 2] if ipa[i : i + 2] in _DIPHTHONGS else ipa[i]
        i += len(ph)
        if ph[0] in _VOWELS:
            tones.append(stress or 1)
            stress = 0
        else:
            tones.append(0)
        phones.append(ph)
    return phones, tones


def english_tokens(sentence: str, n_vocab: int, vocab_size: int, add_blank: bool = True) -> MeloTokens:
    """One sentence → its `MeloTokens` (get_text_for_tts_infer for "EN")."""
    words = re.findall(r"[a-z']+|[^a-z'\s]", normalize_english(sentence))
    phones, tones, word2ph, pieces = ["_"], [0], [1], [CLS_ID]
    for w in words:
        if re.fullmatch(r"[a-z']+", w):
            ph, tn = word_phones(w)
        else:
            ph, tn = [w], [0]
        phones += ph
        tones += tn
        word2ph.append(len(ph))
        pieces.append(_hash(w, WORDPIECE_FIRST, vocab_size - WORDPIECE_FIRST))
    phones.append("_")
    tones.append(0)
    word2ph.append(1)
    pieces.append(SEP_ID)
    ids = [0 if p == "_" else _hash(p, 1, n_vocab - 1) for p in phones]
    start = language_tone_start_map["EN"]
    tones = [t + start for t in tones]
    langs = [EN_LANGUAGE_ID] * len(ids)
    if add_blank:
        ids, tones, langs = (_intersperse(x) for x in (ids, tones, langs))
        word2ph = [2 * n for n in word2ph]
        word2ph[0] += 1
    return MeloTokens(*(np.asarray(x, np.int32) for x in (ids, tones, langs, pieces, word2ph)))


def _intersperse(seq: list[int]) -> list[int]:
    out = [0] * (2 * len(seq) + 1)
    out[1::2] = seq
    return out


def phone_word_index(word2ph: np.ndarray, length: int) -> np.ndarray:
    """[length] int64: the wordpiece each phone's BERT feature comes from
    (melo/text/english_bert.py repeats row i word2ph[i] times); phones past
    Σ word2ph take wordpiece 0."""
    idx = np.zeros(length, np.int64)
    idx[: int(word2ph.sum())] = np.repeat(np.arange(len(word2ph)), word2ph)
    return idx


def split_pieces(text: str) -> list[str]:
    """MeloTTS's split of Latin-script text (split_utils.py
    split_sentences_latin): quotes and brackets normalised, then txtsplit
    into pieces of about 256 characters, at most 512, kept whole at sentence
    ends where it can."""
    text = re.sub("[。！？；]", ".", text)
    text = re.sub("[，]", ",", text)
    text = re.sub("[“”]", '"', text)
    text = re.sub("[‘’]", "'", text)
    text = re.sub(r"[\<\>\(\)\[\]\"\«\»]+", "", text)
    return [p.strip() for p in txtsplit(text, 256, 512) if p.strip()]


def txtsplit(text: str, desired_length: int = 100, max_length: int = 200) -> list[str]:
    """Split text into chunks of about `desired_length` characters, at most
    `max_length`, at sentence ends where it can (MeloTTS's txtsplit)."""
    text = re.sub(r"\n\n+", "\n", text)
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"[“”]", '"', text)
    text = re.sub(r"([,.?!])", r"\1 ", text)
    text = re.sub(r"\s+", " ", text)
    rv: list[str] = []
    in_quote, current, split_pos, pos, end_pos = False, "", [], -1, len(text) - 1

    def seek(delta: int) -> str:
        nonlocal pos, in_quote, current
        is_neg = delta < 0
        for _ in range(abs(delta)):
            if is_neg:
                pos -= 1
                current = current[:-1]
            else:
                pos += 1
                current += text[pos]
            if text[pos] == '"':
                in_quote = not in_quote
        return text[pos]

    def peek(delta: int) -> str:
        p = pos + delta
        return text[p] if 0 <= p < end_pos else ""

    def commit() -> None:
        nonlocal current, split_pos
        rv.append(current)
        current, split_pos = "", []

    while pos < end_pos:
        c = seek(1)
        if len(current) >= max_length:
            if split_pos and len(current) > desired_length / 2:
                seek(-(pos - split_pos[-1]))
            else:
                while c not in "!?.\n " and pos > 0 and len(current) > desired_length:
                    c = seek(-1)
            commit()
        elif not in_quote and (c in "!?\n" or (c in ".," and peek(1) in "\n ")):
            while pos < len(text) - 1 and len(current) < max_length and peek(1) in "!?.":
                c = seek(1)
            split_pos.append(pos)
            if len(current) >= desired_length:
                commit()
        elif in_quote and peek(1) == '"' and peek(2) in "\n ":
            seek(2)
            split_pos.append(pos)
    rv.append(current)
    rv = [s.strip() for s in rv]
    return [s for s in rv if s and not re.match(r"^[\s\.,;:!?]*$", s)]
