"""Audio watermarking: the port's numpy copy of
``openvoice_tpu/pipeline/watermark.py``, bit-equal to it.

API-compatible with the reference's wavmark usage (api.py:162-201): 32 bits
embedded per 16,000-sample window, one window per 32,000 samples; 8-char
messages via `string_to_bits`.

wavmark is an external neural model; here the watermark is a self-contained
QIM (quantization-index-modulation) scheme (SURVEY.md §2.4 'reimplement ...
or a DSP watermark'):

* each 16 k window carries 32 bits on 32 orthonormal carriers spanning the
  whole window.  Carriers are *band-limited* to 300–6000 Hz (then QR-
  orthonormalized, which stays inside the band-limited subspace) so the
  watermark rides the part of the spectrum that resampling and speech codecs
  preserve — a white-noise carrier dies at the first 16 kHz resample;
* the correlation c_i = ⟨window, pn_i⟩ is *quantized* to the nearest even
  (bit 0) or odd (bit 1) multiple of Δ by adding (c'−c)·pn_i — host-signal
  interference cancels exactly (orthonormal carriers);
* decode: bit_i = round(c_i/Δ) mod 2.

Δ = 8e-2 leaves a ±Δ/2 = ±4e-2 correlation margin: ≈ 4σ against −40 dBFS
additive white noise (which induces N(0, 1e-2) correlation noise on a
unit-norm carrier), three orders above PCM16 quantization noise, and far
above the ≈2e-4 correlation error of a 22.05 k→16 k→22.05 k resample
round-trip on band-limited carriers.  Embedding distortion is ≈ −55 dBFS
rms, confined to the speech band where it is masked — which is also why
REAL lossy codecs keep it: measured with in-repo lame/libopus round trips,
the mark survives mp3 and Opus at ≥96 kbps on broadband hosts and 64 kbps
on real speech (Opus needs the sub-sample resync below: its pre-skip is a
constant fractional 22.05 kHz offset).  Measured survival limits live in
docs/QA.md (measured on the JAX package's copy; this one is bit-equal).
Provenance marking, not cryptography.
"""

from __future__ import annotations

import numpy as np

from openvoice_tpu_torch.runtime.profiler import trace
from openvoice_tpu_torch.utils import bits_to_string, string_to_bits

K = 16000  # samples per watermark window (api.py:169)
COEFF = 2  # one window per COEFF·K samples (api.py:170)
BITS_PER_WINDOW = 32
_DELTA = 8e-2
_BAND = (300.0, 6000.0)  # carrier band, Hz (survives 16 kHz resampling)
_SR = 22050.0  # nominal rate the band edges are designed for


N_IDX_BITS = 8  # per-slot absolute-index tag: slot m carries m mod 256


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
    with trace("ov.watermark", args={"samples": len(audio)}):
        audio = np.array(audio, dtype=np.float32, copy=True)
        bits = string_to_bits(message).reshape(-1)
        n_repeat = len(bits) // BITS_PER_WINDOW
        n_slots = max(0, (len(audio) - K) // (COEFF * K) + 1)
        if n_slots < n_repeat:
            print("Audio too short, fail to add watermark")
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


# lattice-fit residual below this = "this really is our QIM lattice".
# Clean decode residual is < 1e-3; an unwatermarked window scores ≈0.25
# (uniform); measured watermarked-after-abuse residuals stay under 0.06.
_RESIDUAL_OK = 0.10

# Gray zone: a lattice blurred by IN-BAND codec noise (Vorbis noise-fill,
# low-rate mp3) sits at 0.10-0.18 — still ≥5σ below the 0.25 chance level
# for a SINGLE un-searched test (σ ≈ 0.072/√32 per window), but unreliable
# bit-by-bit.  The gray path soft-combines QIM log-likelihoods across all
# cyclic slot copies (σ shrinks √copies) at TRIVIAL alignment only; the
# searched resync keeps the strict 0.10 bar because its ~10⁶ candidate
# draws produce false locks at 0.13-0.15 (measured, opus diagnostics).
_RESIDUAL_GRAY = 0.20


def _lattice_residual(corr: np.ndarray, gain: float) -> float:
    """Mean distance of corr/(gain·Δ) to the nearest lattice point (any
    parity).  ≈0 on the true (offset, gain), ≈0.25 anywhere else."""
    v = corr / (gain * _DELTA)
    return float(np.mean(np.abs(v - np.round(v))))


def _refine_gain(corr: np.ndarray, g0: float) -> float:
    """Least-squares gain against the lattice: c_i ≈ g·Δ·q_i."""
    g = g0
    for _ in range(3):
        q = np.round(corr / (g * _DELTA))
        num = float(np.dot(corr, q))
        den = float(np.dot(q, q)) * _DELTA
        if den <= 0:
            return g
        g = num / den
    return g


def _frac_shift(x: np.ndarray, d: float) -> np.ndarray:
    """x advanced by a fractional d samples (y[t] = x[t+d]) via an FFT phase
    ramp.  |d| < 1 in practice, so the circular wrap touches negligible
    energy.  Codecs that run at a different internal rate (Opus: 48/24 kHz)
    return their constant pre-skip delay as a NON-integer number of samples
    at our 22.05 kHz — e.g. 156 samples at 24 kHz = 143.325 here — and a
    fractional delay is an all-pass whose phase rotation decorrelates the
    upper carrier band (0.33 samples ≈ 0.56 rad at 6 kHz), so the integer
    resync alone locks but decodes dirty."""
    n = len(x)
    f = np.fft.rfftfreq(n)
    return np.fft.irfft(np.fft.rfft(x) * np.exp(2j * np.pi * f * d), n).astype(
        np.float32
    )


def _refine_frac(
    window: np.ndarray, gain: float
) -> tuple[float, float, float, np.ndarray]:
    """Best (frac_offset, gain, residual, correlations) over sub-sample
    shifts of one locked window: coarse 1/8-sample grid, then a 1/32-sample
    sweep around the coarse winner.  Gain is re-fit at each candidate (a
    fractional shift slightly re-scales correlations)."""
    spec = np.fft.rfft(window)
    f = np.fft.rfftfreq(K)
    corr0 = (_PN @ window).astype(np.float64)
    best = (0.0, gain, np.inf, corr0)
    coarse = np.arange(-4, 5) / 8.0
    for stage in range(2):
        grid = (
            coarse
            if stage == 0
            else best[0] + np.arange(-3, 4) / 32.0
        )
        for d in grid:
            w = np.fft.irfft(spec * np.exp(2j * np.pi * f * d), K)
            corr = (_PN @ w).astype(np.float64)
            g = _refine_gain(corr, best[1])
            res = _lattice_residual(corr, g)
            if res < best[2]:
                best = (float(d), g, res, corr)
    return best


def _constellation_ok(corr: np.ndarray, gain: float) -> bool:
    """The degenerate-fit guards of the integer search (all-zero and
    all-even constellations — see _resync_window), applied to one refined
    candidate so a collapsed fit can't outrank the true lag."""
    q = np.round(corr / (gain * _DELTA)).astype(np.int64)
    return np.count_nonzero(q) >= 8 and np.count_nonzero(q & 1) >= 2


_BANKS: list[tuple[float, np.ndarray]] | None = None


def _carrier_banks() -> list[tuple[float, np.ndarray]]:
    """[(δ, carriers shifted by −δ)] for δ ∈ {0, −1/3, +1/3} — deterministic
    constants, built once (64 FFTs) and cached."""
    global _BANKS
    if _BANKS is None:
        _BANKS = [(0.0, _PN)] + [
            (d, np.stack([_frac_shift(p, -d) for p in _PN]))
            for d in (-1.0 / 3.0, 1.0 / 3.0)
        ]
    return _BANKS


def _resync_window(audio: np.ndarray, win_start: int, max_offset: int,
                   gain_db: float, n_gains: int = 25
                   ) -> tuple[int, float, float] | None:
    """Joint (offset, gain) search around one watermark window.

    Correlates every carrier against all candidate offsets in
    [win_start - max_offset, win_start + max_offset] at once (FFT
    cross-correlation), then scores the QIM lattice-fit residual over a
    log-spaced gain grid.  Returns (offset, gain, residual) of the best
    fit, or None if no non-degenerate fit exists.  offset is where original
    sample 0 sits in `audio` (positive = leading padding was added,
    negative = the head was cut).
    """
    lo = win_start - max_offset
    hi = win_start + max_offset
    lo = max(lo, -(K - 1))       # window must overlap the audio at all
    hi = min(hi, len(audio) - K)
    if hi < lo:
        return None
    # window content for offset s lives at audio[s : s+K); build one padded
    # segment so s=lo maps to segment index 0 (missing head samples = 0)
    pad_l = max(0, -lo)
    seg = np.concatenate([np.zeros(pad_l, np.float32),
                          np.asarray(audio[max(0, lo) : hi + K], np.float32)])
    n_lags = hi - lo + 1
    nfft = 1 << int(np.ceil(np.log2(len(seg) + K)))
    a_f = np.fft.rfft(seg, nfft)
    gains = 10.0 ** (np.linspace(-gain_db, gain_db, n_gains) / 20.0)
    best_res = np.full(n_lags, np.inf)
    best_gain = np.full(n_lags, 1.0)
    c0 = None
    # Three sub-sample-shifted carrier banks (δ = −1/3, 0, +1/3): a
    # fractionally-delayed lattice (Opus pre-skip at its 24/48 kHz internal
    # rate = non-integer 22.05 kHz samples) scores only ~0.12-0.15 against
    # the unshifted bank — INSIDE the false-lock noise floor (~0.13) of a
    # 32k-lag × 25-gain search, so the true lag doesn't even rank.  With the
    # banks the worst-case sub-sample mismatch is 1/6 sample (residual
    # ~0.06), cleanly below the floor.  c_i(s) for bank δ uses carriers
    # shifted by −δ ≡ window content advanced by +δ.
    for bank_d, pn in _carrier_banks():
        p_f = np.fft.rfft(pn[:, ::-1], nfft, axis=1)
        # c_i(s) = Σ_t seg[(s-lo)+t]·pn_i[t] at index (s-lo)+K-1
        c_all = np.fft.irfft(a_f[None, :] * p_f, nfft, axis=1)[:, K - 1 : K - 1 + n_lags]
        if bank_d == 0.0:
            c0 = c_all  # exact-lag correlations for the refine stage below
        for g in gains:
            v = c_all / (g * _DELTA)
            q = np.round(v).astype(np.int64)
            res = np.mean(np.abs(v - q), axis=0)  # [n_lags]
            # two degenerate fits must be rejected before trusting the
            # residual:
            # (a) all-zero constellation — a mostly-out-of-range window
            # correlates to ~0 with every carrier and "fits" at any large
            # gain;
            # (b) all-EVEN constellation — fitting at half the true gain
            # maps every correlation onto an even multiple (residual ~0,
            # all bits decode 0).  Legitimate payload windows always carry
            # odd-parity entries: every 8-bit char row has ≥1 one-bit
            # (col-2 markers on pad rows, nonzero char codes otherwise),
            # ≥4 per 32-bit window.
            ok = (np.count_nonzero(q, axis=0) >= 8) & (
                np.count_nonzero(q & 1, axis=0) >= 2
            )
            res = np.where(ok, res, np.inf)
            upd = res < best_res
            best_res = np.where(upd, res, best_res)
            best_gain = np.where(upd, g, best_gain)
    c_all = c0
    if not np.isfinite(best_res.min()):
        return None
    # A fractionally-delayed lattice (Opus pre-skip at a non-22.05 kHz
    # internal rate) scores a DIRTY integer residual (~0.12) that false
    # locks elsewhere can undercut — so the integer argmin alone picks the
    # wrong lag.  Frac-refine the few best, mutually-separated integer
    # candidates and let the refined residual decide.
    order = np.argsort(best_res)
    cand_idx: list[int] = []
    for i in order:
        if not np.isfinite(best_res[i]) or len(cand_idx) >= 5:
            break
        if all(abs(int(i) - j) > 2 for j in cand_idx):
            cand_idx.append(int(i))
    best = None  # (abs_off, frac, gain, residual)
    for i in cand_idx:
        corr = c_all[:, i].astype(np.float64)
        g = _refine_gain(corr, float(best_gain[i]))
        res = _lattice_residual(corr, g)
        frac = 0.0
        if res > 0.02:
            # sub-sample refinement on this candidate's window
            window = seg[i : i + K]
            if len(window) == K:
                d, g2, res2, corr2 = _refine_frac(window, g)
                if res2 < res:
                    frac, g, res, corr = d, g2, res2, corr2
        # re-apply the degenerate-constellation guards AFTER refinement:
        # the LS gain fit / frac sweep can collapse onto an all-even or
        # near-zero constellation that scores a spuriously clean residual
        if not _constellation_ok(corr, g):
            continue
        if best is None or res < best[3]:
            best = (lo + i, frac, g, res)
        if best[3] < 0.02:
            break  # clean lattice — worse-ranked candidates can't beat it
    if best is None:
        return None
    off, frac, g, res = best
    return off - win_start, frac, g, res


def _resync(audio: np.ndarray, n_repeat: int, max_offset: int,
            gain_db: float) -> tuple[int, int, float, float, float] | None:
    """Best (boundary_pos, legacy_offset, frac, gain, residual) over the
    message's windows.

    Window 0 is tried first; when its lattice fit is poor (e.g. a head cut
    destroyed part of it) the later windows — intact under any leading trim
    shorter than themselves — recover the (boundary, gain) lock.
    boundary_pos is the ABSOLUTE audio position of the locked window start;
    legacy_offset interprets it as belonging to the window searched around
    (the reading kept for audio without index carriers); frac is the
    sub-sample part of the delay (nonzero after e.g. an Opus round trip)."""
    best = None
    # scan EVERY slot position in the audio, not just the first n_repeat:
    # a leading pad longer than max_offset (e.g. several whole slots of
    # silence) puts the first real content slots beyond the search range of
    # the early windows; later windows — each searched ±max_offset — tile
    # the whole clip, and the per-slot index carriers disambiguate which
    # absolute slot was locked.  The early break keeps common cases at one
    # or two FFT searches.
    # Bounded at 32 positions (≈46 s of leading material): each position is
    # a full FFT × gain-grid search, and UNWATERMARKED audio never locks, so
    # an unbounded scan would make rejection time linear in clip length.
    n_positions = max(max(1, n_repeat), (len(audio) - K) // (COEFF * K) + 1)
    n_positions = min(n_positions, 32)
    for w in range(n_positions):
        win_start = COEFF * w * K
        cand = _resync_window(audio, win_start, max_offset, gain_db)
        if cand is not None and (best is None or cand[3] < best[4]):
            off, frac, g, res = cand
            best = (win_start + off, off, frac, g, res)
        if best is not None and best[4] < 0.02:
            break  # unambiguous lock; skip the remaining FFT searches
    return best


def _framing_offset(audio: np.ndarray, gain: float) -> int:
    """Whole-slot framing correction for trivially-aligned decodes.

    A pad or head trim that is an exact multiple of the COEFF·K slot
    period leaves every window ON the lattice but ROTATES which message
    window each slot carries — the strict/gray decoders would return a
    confidently wrong rotation.  Read the per-slot index carriers at the
    first slot whose payload constellation is real (silence/pad slots are
    degenerate AND tag slot 0 ambiguously — all index bits zero): if the
    index says this is original slot s at audio slot position m, original
    sample 0 sits at COEFF·(m−s)·K.

    The implied offset is read from up to 5 readable slots and put to a
    MAJORITY VOTE (a single index bit error that still passes the decoder's
    rotation-invariant residual gate would otherwise silently rotate the
    message): with ≥2 readable slots a nonzero correction needs ≥2 agreeing
    votes; a lone readable slot is trusted as-is (short audio has no
    redundancy to cross-check).  Returns 0 when aligned, when the audio
    predates index carriers, or when nothing readable is found."""
    n_slots = max(1, (len(audio) - K) // (COEFF * K) + 1)
    votes: list[int] = []
    for m in range(n_slots):
        if len(votes) >= 5:
            break
        pos = COEFF * m * K
        chunk = _window_at(audio, pos)
        if chunk is None:
            break
        corr = (_PN @ chunk).astype(np.float64) / gain
        q = np.round(corr / _DELTA).astype(np.int64)
        if np.count_nonzero(q) < 8 or np.count_nonzero(q & 1) < 2:
            continue  # degenerate payload (pad/silence): index unreadable
        if _lattice_residual(corr, 1.0) >= _RESIDUAL_GRAY:
            continue  # not on the lattice at this slot
        idx_corr = (_PN_IDX @ chunk).astype(np.float64) / gain
        if _lattice_residual(idx_corr, 1.0) >= _RESIDUAL_GRAY:
            return 0  # an embedding without index carriers
        bits = np.round(idx_corr / _DELTA).astype(np.int64) & 1
        slot = int(sum(int(b) << i for i, b in enumerate(bits)))
        votes.append(COEFF * (m - slot) * K)
    if not votes:
        return 0
    if len(votes) == 1:
        return votes[0]
    best = max(set(votes), key=votes.count)
    return best if votes.count(best) >= 2 else 0


def _window_at(audio: np.ndarray, start: int) -> np.ndarray | None:
    """Window [start, start+K) with out-of-range samples zero-filled;
    None if it lies entirely outside the audio."""
    if start >= len(audio) or start + K <= 0:
        return None
    w = np.zeros(K, np.float32)
    a, b = max(0, start), min(len(audio), start + K)
    w[a - start : b - start] = audio[a:b]
    return w


def detect_watermark(
    audio: np.ndarray,
    n_repeat: int,
    *,
    robust: bool = True,
    max_offset: int = K,
    gain_db: float = 6.0,
) -> str:
    """Decode n_repeat windows → message string, or 'Fail' if audio is short
    (api.py:186-201 contract).

    The aligned unit-gain decode is tried first (the plain lattice decode
    on untouched audio).  When its lattice-fit residual says the
    lattice isn't there (re-gained, trimmed, or padded audio) and
    robust=True, a joint (offset, gain) resync search recovers the framing:
    gain via least-squares against the lattice (±gain_db dB), offset via
    FFT cross-correlation over ±max_offset samples — the wavmark-robustness
    behaviors (api.py:105-109) the plain lattice decode lacks.
    """
    audio = np.asarray(audio, dtype=np.float32)
    strict = _decode_windows(audio, n_repeat, 0, 1.0)
    if strict is not None and strict[1] < _RESIDUAL_OK:
        # a whole-slot-period pad/trim keeps every window on the lattice
        # but rotates the message — confirm the framing via the index
        # carriers before trusting the trivial alignment
        off = _framing_offset(audio, 1.0) if robust else 0
        if off != 0:
            fixed = _decode_windows(audio, n_repeat, off, 1.0, cyclic=True)
            if fixed is not None and fixed[1] < _RESIDUAL_OK:
                return fixed[0]
        return strict[0]
    if not robust:
        return "Fail" if strict is None else strict[0]
    if strict is not None and strict[1] < _RESIDUAL_GRAY:
        # lattice present but blurred by in-band codec noise at trivial
        # alignment: soft-combine across all cyclic copies (see
        # _RESIDUAL_GRAY above); gain is re-fit from slot 0 first so a
        # moderate re-gain composed with the codec still lands here
        g0 = 1.0
        if len(audio) >= K:
            corr0 = (_PN @ audio[:K]).astype(np.float64)
            g = _refine_gain(corr0, 1.0)
            if 0.5 <= g <= 2.0 and _constellation_ok(corr0, g):
                g0 = g
        # same whole-slot rotation hazard as the strict path (a gray-zone
        # clip may ALSO carry a slot-multiple pad/trim)
        off = _framing_offset(audio, g0)
        soft = _soft_decode_windows(audio, n_repeat, off, g0)
        if soft is not None and soft[1] < _RESIDUAL_GRAY:
            return soft[0]
    sync = _resync(audio, n_repeat, max_offset, gain_db)
    if sync is None:
        print("Audio too short, fail to detect watermark")
        return "Fail"
    boundary, legacy_offset, frac, gain, residual = sync
    if residual >= _RESIDUAL_OK:
        return "Fail"  # no lattice at any (offset, gain): not our watermark
    if frac != 0.0:
        # the codec delay is constant over the clip, so one global
        # sub-sample shift re-aligns every window at once
        audio = _frac_shift(audio, frac)
    # which absolute slot did we lock onto?  The embedder tags every slot with
    # its index on the orthogonal index carriers; a clean index lattice
    # disambiguates the rotation a head trim introduces.  Audio without
    # index carriers keeps the legacy interpretation.
    offset = legacy_offset
    chunk = _window_at(audio, boundary)
    if chunk is not None:
        idx_corr = (_PN_IDX @ chunk) / gain
        if _lattice_residual(idx_corr, 1.0) < _RESIDUAL_OK:
            idx_bits = np.round(idx_corr / _DELTA).astype(np.int64) & 1
            slot = int(sum(int(b) << i for i, b in enumerate(idx_bits)))
            offset = boundary - COEFF * slot * K
    decoded = _decode_windows(audio, n_repeat, offset, gain, cyclic=True)
    if decoded is None:
        print("Audio too short, fail to detect watermark")
        return "Fail"
    return decoded[0]


def _soft_decode_windows(
    audio: np.ndarray, n_repeat: int, offset: int, gain: float
) -> tuple[str, float] | None:
    """Soft-decision cyclic decode: per message window, sum the QIM parity
    log-likelihood (1 − 2·|frac dev|, signed by the constellation parity)
    over every usable slot copy, so bit noise shrinks with √copies instead
    of riding a single best copy.  Returns (message, mean residual over the
    copies actually combined) or None when a window has no usable copy.
    Copies at chance level (res ≥ 0.23) or with degenerate constellations
    are excluded from both the vote and the acceptance statistic."""
    rows, all_res = [], []
    n_slots_total = max(1, (len(audio) - min(0, offset)) // (COEFF * K) + 2)
    for n in range(n_repeat):
        llr = np.zeros(BITS_PER_WINDOW)
        used = 0
        for m in range(n, n_slots_total, n_repeat):
            start = (COEFF * m) * K + offset
            if start + K <= 0:
                continue
            if start >= len(audio):
                break
            chunk = _window_at(audio, start)
            if chunk is None:
                continue
            corr = (_PN @ chunk).astype(np.float64) / gain
            v = corr / _DELTA
            q = np.round(v).astype(np.int64)
            if np.count_nonzero(q) < 8 or np.count_nonzero(q & 1) < 2:
                continue  # degenerate (trimmed sliver / half-gain) copy
            d = np.abs(v - q)
            res = float(np.mean(d))
            if res >= 0.23:
                continue  # chance-level copy: only noise to add
            llr += np.where((q & 1) == 1, 1.0, -1.0) * (1.0 - 2.0 * d)
            all_res.append(res)
            used += 1
        if used == 0:
            return None
        rows.append((llr > 0).astype(np.int64))
    bits = np.stack(rows).reshape(-1, 8)
    return bits_to_string(bits), float(np.mean(all_res))


def _decode_windows(
    audio: np.ndarray, n_repeat: int, offset: int, gain: float,
    cyclic: bool = False,
) -> tuple[str, float] | None:
    """(message, mean lattice residual) over n_repeat windows, or None when
    a window has no overlap with the audio (reference 'too short' path).

    cyclic=True (the robust path over cyclic embeddings): when message
    window n's primary slot is trimmed away or badly damaged, fall back to
    its later copies (slots n + j·n_repeat) and keep the best lattice fit.
    """
    rows, residuals = [], []
    n_slots_total = max(1, (len(audio) - min(0, offset)) // (COEFF * K) + 2)
    for n in range(n_repeat):
        best = None  # (residual, bits)
        copies = range(n, n_slots_total, n_repeat) if cyclic else [n]
        for m in copies:
            start = (COEFF * m) * K + offset
            if start + K <= 0:
                continue
            if start >= len(audio):
                break
            chunk = (
                _window_at(audio, start)
                if (offset != 0 or gain != 1.0)
                else (audio[start : start + K]
                      if len(audio) >= start + K else None)
            )
            if chunk is None or len(chunk) != K:
                continue
            corr = (_PN @ chunk) / gain
            res = _lattice_residual(corr, 1.0)
            q = np.round(corr / _DELTA).astype(np.int64)
            bits = q & 1
            # a sliver of a trimmed slot correlates to ~0 with every carrier
            # and scores a spuriously clean residual on the all-zero lattice
            # point; demand a real, parity-bearing constellation (legit
            # payload windows always have ≥4 odd entries — see
            # _resync_window) before trusting or early-breaking on a copy
            degenerate = (
                np.count_nonzero(q) < 8 or np.count_nonzero(q & 1) < 2
            )
            if degenerate:
                res = max(res, 0.25)
            if best is None or res < best[0]:
                best = (res, bits)
            if best[0] < 0.02:
                break  # clean lattice: no need to scan further copies
        if best is None:
            if offset == 0 and gain == 1.0:
                print("Audio too short, fail to detect watermark")
            return None
        residuals.append(best[0])
        rows.append(best[1])
    bits = np.stack(rows).reshape(-1, 8)
    return bits_to_string(bits), float(np.mean(residuals))
