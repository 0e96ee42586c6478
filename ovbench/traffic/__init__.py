"""The benchmark's one traffic generator.  A mix is a data file beside this
module, ``<mix>.json``, that the generator reads; a new mix is a new file.

Lengths follow a published corpus statistic: the least-assuming
(maximum-entropy) distribution on [seconds_min, seconds_max] with mean
seconds_mean, a truncated exponential.  Two kinds of request:

* ``clips``: synthetic voiced clips (a vibrato harmonic tone under a
  syllable-rate envelope, with a little noise) of those lengths, each
  converted from one speaker embedding of a pool to another;
* ``text``: lines of a text file, each starting at one of its sentences and
  running on for as many words as the lengths at the corpus's speaking rate
  (``words_per_second``) make, cut to the mix's character limit, each
  spoken by one of the TTS's style speakers and converted to an embedding
  of the pool.

A mix file holds exactly the keys its kind reads (``KEYS``); any other key
is refused, so that no setting is silently ignored.  The loop is closed:
each of ``clients`` callers sends its next request on its last answer.

Every request of a run comes from a pool of ``pool`` requests.  What sets
a request's work is the same for every seed, so that two seeds give the
same work: the lengths (fixed quantiles of the distribution), and the
lines with their style speakers.  The seed draws the pool's order, the
clips' content, the embeddings and each request's own seed (its noise).
Client c of a closed loop sends, as its j-th request, pool item
``(c · pool // clients + j) mod pool``, so every client walks the whole
pool.  The program sees only the requests.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
LENGTHS = {"seconds_min", "seconds_mean", "seconds_max"}
KEYS = {
    "clips": {"kind", "why", "clients", "pool", "speakers", "tau"} | LENGTHS,
    "text": {"kind", "why", "clients", "pool", "speakers", "styles", "tau", "text_file", "words_per_second",
             "min_chars", "max_chars"} | LENGTHS,
}


def load_mix(name: str) -> dict:
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", name):
        raise ValueError(f"bad traffic name {name!r}")
    return json.loads((HERE / f"{name}.json").read_text())


def voice(seconds: float, f0: float, rng: np.random.Generator, sr: int) -> np.ndarray:
    """Speech-like float32 audio: vibrato harmonic tone, syllable-rate
    envelope, noise."""
    tt = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt + rng.uniform(0, 2 * np.pi)), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


def seconds(mix: dict) -> list[float]:
    """The pool's lengths in seconds: quantiles (i + ½)/pool of the
    maximum-entropy distribution on [seconds_min, seconds_max] with mean
    seconds_mean (density ∝ exp(λ·x), λ solved for the mean).  The same
    for every seed."""
    lo, hi, mean = mix["seconds_min"], mix["seconds_max"], mix["seconds_mean"]
    if not lo < mean < hi:
        raise ValueError(f"mean {mean} outside ({lo}, {hi})")
    span = hi - lo

    def mean_of(lam: float) -> float:   # lo + the truncated exponential's mean
        if abs(lam * span) < 1e-9:
            return lo + span / 2
        return lo + span / -np.expm1(-lam * span) - 1 / lam

    a, b = -50 / span, 50 / span
    for _ in range(200):                # mean_of rises with λ
        mid = (a + b) / 2
        a, b = (mid, b) if mean_of(mid) < mean else (a, mid)
    lam = (a + b) / 2
    n = mix["pool"]
    us = [(i + 0.5) / n for i in range(n)]
    if abs(lam * span) < 1e-9:
        return [lo + u * span for u in us]
    return [float(lo + np.log1p(u * np.expm1(lam * span)) / lam) for u in us]


def text_lines(mix: dict) -> list[tuple[str, int]]:
    """The pool's lines and their style speakers, from a fixed generator:
    the same for every seed, since a line's words and speaker set its
    tokens and durations, and so its work.  Line i starts at sentence
    i mod (sentences) of the text file and runs on, past the end back to
    the start, for round(words_per_second · length) words."""
    rng = np.random.default_rng(0)
    text = " ".join((HERE / mix["text_file"]).read_text().split())
    sentences = [s.split() for s in re.findall(r"[^.?!]+[.?!]", text)]
    words = [w for s in sentences for w in s]
    starts = np.cumsum([0] + [len(s) for s in sentences[:-1]])
    counts = [max(1, round(mix["words_per_second"] * s)) for s in seconds(mix)]
    lines = []
    for i, j in enumerate(rng.permutation(len(counts))):
        start = int(starts[i % len(sentences)])
        chosen = [words[(start + k) % len(words)] for k in range(counts[j])]
        lines.append((_line(chosen, mix["max_chars"]), int(rng.integers(mix["styles"]))))
    return lines


def _line(words: list[str], max_chars: int) -> str:
    """The words as one typed line: cut at the last whole word within
    `max_chars`, closed as a sentence."""
    text = " ".join(words)
    if len(text) > max_chars:
        text = text[: max_chars - 1].rsplit(" ", 1)[0]
    text = text.rstrip(",;:- ")
    return text if text[-1] in ".?!" else text + "."


class Traffic:
    """The requests of one run: `pool` from the mix and the seed,
    `request(c, j)` what client c sends as its j-th request."""

    def __init__(self, mix: dict, seed: int, gin: int, sampling_rate: int):
        if set(mix) != KEYS.get(mix.get("kind"), set()):
            raise ValueError(f"traffic kind {mix.get('kind')!r} takes the keys {sorted(KEYS.get(mix.get('kind'), ()))}; "
                             f"the mix has {sorted(mix)}")
        self.clients = int(mix["clients"])
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7AF]))
        n = mix["pool"]
        ses = (0.3 * rng.standard_normal((mix["speakers"] + 1, gin))).astype(np.float32)
        self.base_se = ses[-1]
        order = rng.permutation(n)
        self.pool = []
        if mix["kind"] == "clips":
            lengths = seconds(mix)
            for i in range(n):
                s = lengths[order[i]]
                self.pool.append({
                    "index": i, "seconds_in": s, "audio": voice(s, float(rng.uniform(90, 240)), rng, sampling_rate),
                    "src": ses[rng.integers(mix["speakers"])], "tgt": ses[rng.integers(mix["speakers"])],
                    "seed": int(rng.integers(2 ** 31 - 1)), "tau": float(mix["tau"])})
        elif mix["kind"] == "text":
            lines = text_lines(mix)
            for i in range(n):
                text, speaker = lines[order[i]]
                if not mix["min_chars"] <= len(text) <= mix["max_chars"]:
                    raise ValueError(f"line of {len(text)} characters")
                self.pool.append({
                    "index": i, "text": text, "speaker": speaker, "src": self.base_se,
                    "tgt": ses[rng.integers(mix["speakers"])], "seed": int(rng.integers(2 ** 31 - 1)),
                    "tau": float(mix["tau"])})

    def request(self, client: int, j: int) -> dict:
        n = len(self.pool)
        return self.pool[(client * n // self.clients + j) % n]
