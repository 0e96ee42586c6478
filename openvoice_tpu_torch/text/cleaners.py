"""Cleaners: language-tagged text → IPA (reference: text/cleaners.py).

`cjke_cleaners2` dispatches [ZH]/[JA]/[KO]/[EN] spans.  The reference
*advertises* all four (text/cleaners.py:5-16) but its JA/KO handlers are
referenced without ever being imported or defined (text/cleaners.py:9,11 — a
latent NameError), so V1 there effectively supports EN and ZH only.  Here all
four work: JA/KO are self-contained implementations constrained to the same
checkpoint symbol inventory (see text/japanese.py, text/korean.py).
"""

from __future__ import annotations

import re

from openvoice_tpu_torch.text.english import english_to_ipa2
from openvoice_tpu_torch.text.japanese import japanese_to_ipa2
from openvoice_tpu_torch.text.korean import korean_to_ipa
from openvoice_tpu_torch.text.mandarin import chinese_to_ipa


def cjke_cleaners2(text: str) -> str:
    # strict=False: the cleaner is the serving-facing path, and all
    # languages degrade uniformly on OOV (warn-and-skip like ZH,
    # VERDICT r3 next #4) — a rare kanji must not throw a request away.
    # Library users wanting the hard error call japanese_to_ipa2(strict=True).
    text = re.sub(r"\[ZH\](.*?)\[ZH\]", lambda m: chinese_to_ipa(m.group(1)) + " ", text)
    text = re.sub(r"\[JA\](.*?)\[JA\]", lambda m: japanese_to_ipa2(m.group(1), strict=False) + " ", text)
    text = re.sub(r"\[KO\](.*?)\[KO\]", lambda m: korean_to_ipa(m.group(1)) + " ", text)
    text = re.sub(r"\[EN\](.*?)\[EN\]", lambda m: english_to_ipa2(m.group(1)) + " ", text)
    text = re.sub(r"\s+$", "", text)
    text = re.sub(r"([^\.,!\?\-…~])$", r"\1.", text)
    return text
