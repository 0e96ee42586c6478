"""The watermark of the reference: OpenVoice's embedding step
(reference repository: openvoice/api.py:162-184, 32 bits a 16,000-sample
window, one window a 32,000 samples), as the PyTorch port implements it
with a band-limited QIM scheme in place of the external ``wavmark`` model.

A frozen copy of the port's embedding (``add_watermark`` and what it reads);
the detector is not needed to judge an output and is left out, and so
is the notice printed for audio shorter than one message.
"""

from __future__ import annotations

import numpy as np


def string_to_bits(string: str, pad_len: int = 8) -> np.ndarray:
    """Message → [pad_len, 8] bit matrix; unused rows carry a marker bit in
    column 2 (utils.py:59 — '32 bits per chunk' framing depends on it)."""
    bit_rows = [[int(b) for b in bin(ord(c))[2:].zfill(8)] for c in string]
    arr = np.array(bit_rows, dtype=np.int64) if bit_rows else np.zeros((0, 8), np.int64)
    full = np.zeros((pad_len, 8), dtype=arr.dtype)
    full[:, 2] = 1
    n = min(pad_len, len(arr))
    full[:n] = arr[:n]
    return full


K = 16000


COEFF = 2


BITS_PER_WINDOW = 32


_DELTA = 8e-2


_BAND = (300.0, 6000.0)


_SR = 22050.0


N_IDX_BITS = 8


def _pn_matrix() -> np.ndarray:
    """[32, K] orthonormal band-limited carriers (fixed seed, cached)."""
    rng = np.random.default_rng(0x0BEC0DE)
    pn = rng.standard_normal((BITS_PER_WINDOW, K))
    spec = np.fft.rfft(pn, axis=1)
    freqs = np.fft.rfftfreq(K, 1.0 / _SR)
    spec[:, (freqs < _BAND[0]) | (freqs > _BAND[1])] = 0.0
    pn = np.fft.irfft(spec, K, axis=1)
    # Gram–Schmidt via QR on the transpose: columns of q span the same
    # band-limited subspace and are exactly orthonormal
    q, _ = np.linalg.qr(pn.T)
    return np.ascontiguousarray(q.T, dtype=np.float32)


_PN = _pn_matrix()


def _pn_idx_matrix() -> np.ndarray:
    """[N_IDX_BITS, K] index carriers: band-limited, orthonormal, and
    orthogonal to the payload carriers (projected out before QR), so index
    QIM never perturbs payload correlations and vice versa."""
    rng = np.random.default_rng(0x1DECAF)
    pn = rng.standard_normal((N_IDX_BITS, K))
    spec = np.fft.rfft(pn, axis=1)
    freqs = np.fft.rfftfreq(K, 1.0 / _SR)
    spec[:, (freqs < _BAND[0]) | (freqs > _BAND[1])] = 0.0
    pn = np.fft.irfft(spec, K, axis=1)
    pn -= (pn @ _PN.T) @ _PN  # project out the payload subspace
    q, _ = np.linalg.qr(pn.T)
    return np.ascontiguousarray(q.T, dtype=np.float32)


_PN_IDX = _pn_idx_matrix()


def _qim_embed(chunk: np.ndarray, carriers: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Parity-QIM `bits` onto `carriers` in one window; returns the delta."""
    c = carriers @ chunk
    q = np.round(c / _DELTA)
    wrong_parity = (q.astype(np.int64) & 1) != bits
    # move to the closer adjacent multiple when parity is wrong
    q = np.where(wrong_parity, q + np.where(c / _DELTA >= q, 1, -1), q)
    c_target = (q * _DELTA).astype(np.float32)
    return (c_target - c) @ carriers


def add_watermark(audio: np.ndarray, message: str) -> np.ndarray:
    """Embed `message` (≤8 chars) into a mono float waveform; returns a copy.

    Mirrors the reference loop structure (api.py:162-184): window (slot) m
    covers samples [2mK, (2m+1)K); short windows are skipped with a notice.
    The message repeats CYCLICALLY over every full slot in the audio
    (slot m carries message window m mod n_repeat), and each slot also
    carries its absolute index m on the orthogonal index carriers — so a
    head-trimmed copy still contains complete message cycles AND enough
    information to recover the global framing (wavmark-style arbitrary-
    position sync, reference api.py:105-109).  The first n_repeat slots are
    embedded exactly as before, so offset-0 decoding is unchanged.
    """
    if not message:
        return audio
    audio = np.array(audio, dtype=np.float32, copy=True)
    bits = string_to_bits(message).reshape(-1)
    n_repeat = len(bits) // BITS_PER_WINDOW
    n_slots = max(0, (len(audio) - K) // (COEFF * K) + 1)
    for m in range(n_slots):
        start = (COEFF * m) * K
        chunk = audio[start : start + K]
        n = m % n_repeat
        window_bits = bits[n * BITS_PER_WINDOW : (n + 1) * BITS_PER_WINDOW]
        idx_bits = np.array([(m >> b) & 1 for b in range(N_IDX_BITS)], np.int64)
        audio[start : start + K] = (
            chunk
            + _qim_embed(chunk, _PN, window_bits)
            + _qim_embed(chunk, _PN_IDX, idx_bits)
        )
    return audio
