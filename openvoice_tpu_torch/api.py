"""User-facing API of the PyTorch port: `ToneColorConverter` and
`BaseSpeakerTTS`.

Mirrors ``openvoice_tpu/api.py`` and through it the reference surface
(api.py:14-201).  The converter runs end to end in both numeric modes: host
reflect-pad → STFT kernel (``csrc/stft.cu``) → posterior encoder → flow →
decoder → watermark.  ``convert(fast=False)`` is the f32 parity mode on stock
layers; ``convert(fast=True)`` is the bf16 serving mode, whose WaveNet, flow
and decoder stages are hand-written kernels (``csrc/{wn,coupling,mrf,tail}.cu``).
The base-speaker TTS encodes text in f32 and decodes in either mode, the
serving mode through the flow and decoder kernels.  `convert_streaming`
converts audio of any length in fixed windows (``runtime/streaming.py``), and
the fused chains `tts_convert_batched`, `tts_convert_single_dispatch` and
`tts_convert_stream` take text to cloned audio with the base audio kept on
the device.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that, they raise.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from openvoice_tpu_torch.audio.io import load_audio, write_wav
from openvoice_tpu_torch.audio.stft import host_spectrogram
from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax
from openvoice_tpu_torch.ckpt.native_io import load_npz
from openvoice_tpu_torch.ckpt.torch_import import load_torch_checkpoint
from openvoice_tpu_torch.config import HParams, SynthesizerConfig, load_hparams
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
from openvoice_tpu_torch.pipeline import watermark as wm
from openvoice_tpu_torch.pipeline.se_extractor import split_audio_vad
from openvoice_tpu_torch.pipeline.whisper_seg import make_segmenter, split_audio_whisper
from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket
from openvoice_tpu_torch.runtime.streaming import voice_conversion_streaming


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU.  There is no silent CPU path: without CUDA the
    caller must ask for ``device="cpu"``.  A CUDA device always comes back
    with its index (``"cuda"`` → ``cuda:<current>``), so that two objects
    made with ``"cuda"`` and ``None`` compare equal."""
    d = torch.device("cuda") if device is None else torch.device(device)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _spec_from_audio(audio: np.ndarray, cfg: SynthesizerConfig) -> tuple[np.ndarray, int]:
    """Host reflect-pad + true frame count; returns (padded_audio_1d, n_frames).

    Matches spectrogram_torch framing (mel_processing.py:54-74): pad
    (n_fft-hop)/2 reflect on both sides, center=False.
    """
    pad = (cfg.filter_length - cfg.hop_length) // 2
    padded = np.concatenate([audio[1 : pad + 1][::-1], audio, audio[-pad - 1 : -1][::-1]])
    n_frames = (len(padded) - cfg.filter_length) // cfg.hop_length + 1
    return padded, n_frames


class OpenVoiceBaseClass:
    """Config, weights, device and the serving cache, shared by both classes
    (reference api.py:14-39; the JAX package's ``OpenVoiceBaseClass``)."""

    def __init__(self, config_path: str | None = None, cfg: SynthesizerConfig | None = None, *,
                 device: str | torch.device | None = None):
        if config_path is not None:
            self.hps: HParams | None = load_hparams(config_path)
            self.cfg = SynthesizerConfig.from_hparams(self.hps)
            self.version = self.hps.get("_version_", "v1")
        else:
            if cfg is None:
                raise ValueError("pass config_path or cfg")
            self.hps = None
            self.cfg = cfg
            self.version = "v2" if cfg.zero_g else "v1"
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Parity mode is real f32.  cuDNN convolutions default to TF32,
            # which keeps ~3 decimal digits and breaks the 1e-4 bars; turn it
            # off for convolutions and matrix products alike.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model: S.Synthesizer | None = None
        self._dec_cache: dict | None = None

    # -- weights ------------------------------------------------------------

    def init_random(self, seed: int = 0) -> None:
        """Random weights (development and benchmarking without a checkpoint)."""
        model = S.init_synthesizer(self.cfg, torch.Generator().manual_seed(seed))
        self.set_model(model)

    def load_ckpt(self, ckpt_path: str) -> dict:
        """Load a reference ``.pth`` or a JAX-package ``.npz`` (its
        ``ckpt/native_io.py::save_npz``); returns the missing/unexpected
        report.  A ``.pth`` goes through ``ckpt/torch_import.py``, with the
        JAX importer's semantics key for key (a missing bias is zeros, a
        missing conv weight raises; strict=False reporting, api.py:35-39);
        an ``.npz`` loads strictly and reports nothing, as in the JAX
        package."""
        if ckpt_path.endswith(".npz"):
            model = synthesizer_from_jax(load_npz(ckpt_path), self.cfg)
            report = {"missing": [], "unexpected": []}
        else:
            model, report = load_torch_checkpoint(ckpt_path, self.cfg)
        self.set_model(model)
        print(f"Loaded checkpoint '{ckpt_path}'")
        print("missing/unexpected keys:", report["missing"], report["unexpected"])
        return report

    def set_model(self, model: S.Synthesizer) -> None:
        """Use `model`'s weights (moved to this instance's device)."""
        self.model = model.to(self.device).eval()
        self._dec_cache = None  # packed from the old weights

    def _require_model(self) -> S.Synthesizer:
        if self.model is None:
            raise RuntimeError("no weights loaded: call load_ckpt() or init_random()")
        return self.model

    def _require_dec_cache(self) -> dict:
        """The serving mode's packed weights (`S.make_dec_cache`): packed
        once, at the first fast call, and again after new weights."""
        if self._dec_cache is None:
            self._dec_cache = S.make_dec_cache(self._require_model())
        return self._dec_cache


class ToneColorConverter(OpenVoiceBaseClass):
    """Zero-shot tone-colour conversion (reference api.py:101-201)."""

    def __init__(self, config_path: str | None = None, cfg: SynthesizerConfig | None = None, *,
                 device: str | torch.device | None = None, enable_watermark: bool = True):
        super().__init__(config_path, cfg, device=device)
        self.enable_watermark = enable_watermark

    # -- speaker embeddings -------------------------------------------------

    def extract_se(self, ref_wav_list, se_save_path: str | None = None) -> np.ndarray:
        """Per-file SE then mean over files (api.py:114-139); returns
        [1, gin, 1] like the reference's SE tensors."""
        if isinstance(ref_wav_list, str):
            ref_wav_list = [ref_wav_list]
        audios = [load_audio(f, sr=self.cfg.sampling_rate)[0] for f in ref_wav_list]
        # one bucketed batch over all files; the batch mean IS the per-file
        # mean (api.py:133) since each row is one file's whole-recording SE
        out = self._se_from_audio_batch(audios)[None, :, None].astype(np.float32)
        if se_save_path is not None:
            os.makedirs(os.path.dirname(se_save_path) or ".", exist_ok=True)
            np.save(se_save_path if se_save_path.endswith(".npy") else se_save_path + ".npy", out)
        return out

    def extract_se_from_file(self, audio_path: str, vad: bool = True) -> np.ndarray:
        """Segment a reference recording, batch the segments through ref_enc,
        mean → [1, gin, 1] (the get_se fast path).

        vad=True: the energy-VAD splitter (the served default).  vad=False:
        whisper-mode segmentation (reference se_extractor.py:19-74) when
        cached ASR weights exist, else the whole file as one segment, as the
        JAX package does (openvoice_tpu/api.py:157-178)."""
        audio, sr = load_audio(audio_path, sr=self.cfg.sampling_rate)
        if vad:
            segments = split_audio_vad(audio, sr)
        else:
            seg = make_segmenter(prefer_whisper=True)
            segments = (split_audio_whisper(audio, sr, seg) if seg else []) or [audio]
        se = self._se_from_audio_batch(segments)
        return se[None, :, None].astype(np.float32)

    @torch.inference_mode()
    def _se_from_audio_batch(self, audios: list[np.ndarray]) -> np.ndarray:
        """Mean tone colour over a batch of same-speaker clips → [gin].

        All clips run as one length-aware batch, padded to the largest clip's
        bucket, with the true frame counts as lengths."""
        model, cfg = self._require_model(), self.cfg
        prepared = [_spec_from_audio(a, cfg) for a in audios]
        bucket = round_up_to_bucket(max(n for _, n in prepared))
        target_len = (bucket - 1) * cfg.hop_length + cfg.filter_length
        batch = np.zeros((len(prepared), target_len), np.float32)
        lengths = np.zeros(len(prepared), np.int64)
        for i, (padded, n_frames) in enumerate(prepared):
            batch[i, : len(padded)] = padded
            lengths[i] = n_frames
        spec = stft_magnitude(torch.from_numpy(batch).to(self.device),
                              cfg.filter_length, cfg.hop_length, cfg.win_length)
        ses = S.extract_tone_color(model, spec, torch.from_numpy(lengths).to(self.device))
        return ses.mean(dim=0).cpu().numpy()

    # -- conversion ---------------------------------------------------------

    @torch.inference_mode()
    def convert(self, audio_src_path, src_se, tgt_se, output_path: str | None = None,
                tau: float = 0.3, message: str = "default", seed: int = 0, fast: bool = False):
        """Reference-compatible convert (api.py:141-160).

        `audio_src_path` may be a path or a float waveform at sampling_rate.
        src/tgt SE accept [1, gin, 1] (reference layout) or [gin].
        fast=True is the serving mode: bf16 after the STFT, through the
        hand-written kernels.
        """
        model, cfg = self._require_model(), self.cfg
        if isinstance(audio_src_path, (str, os.PathLike)):
            audio, _ = load_audio(str(audio_src_path), sr=cfg.sampling_rate)
        else:
            audio = np.asarray(audio_src_path, np.float32)

        padded, n_frames = _spec_from_audio(audio, cfg)
        bucket = round_up_to_bucket(n_frames)
        buf = np.zeros((1, (bucket - 1) * cfg.hop_length + cfg.filter_length), np.float32)
        buf[0, : len(padded)] = padded
        # host noise, drawn exactly as the JAX package draws it
        noise = np.random.default_rng(seed).standard_normal(
            (1, bucket, cfg.inter_channels)).astype(np.float32)

        dev = self.device
        spec = stft_magnitude(torch.from_numpy(buf).to(dev),
                              cfg.filter_length, cfg.hop_length, cfg.win_length)
        out, _ = S.voice_conversion(
            model, spec, torch.tensor([n_frames], device=dev),
            self._as_g(src_se), self._as_g(tgt_se), float(tau), torch.from_numpy(noise).to(dev),
            fast=fast, dec_cache=self._require_dec_cache() if fast else None,
        )
        audio_out = out[0, : n_frames * cfg.upsample_factor, 0].cpu().numpy()
        if self.enable_watermark and message:
            audio_out = self.add_watermark(audio_out, message)
        if output_path is None:
            return audio_out
        write_wav(output_path, audio_out, cfg.sampling_rate)
        return None

    def convert_streaming(self, audio_src_path, src_se, tgt_se, output_path: str | None = None,
                          tau: float = 0.3, message: str = "default", seed: int = 0, fast: bool = True,
                          chunk_frames: int = 896):
        """Constant-memory conversion of recordings of any length: the
        spectrogram streams through fixed [1, halo + chunk + halo] windows
        (``runtime/streaming.py``), equal to `convert` up to float round-off
        for the same seed and tau.  The STFT runs on the host (float64
        numpy): the design keeps the whole spectrogram in host memory and
        uploads one window at a time."""
        cfg = self.cfg
        model = self._require_model()
        if isinstance(audio_src_path, (str, os.PathLike)):
            audio, _ = load_audio(str(audio_src_path), sr=cfg.sampling_rate)
        else:
            audio = np.asarray(audio_src_path, np.float32)
        padded, n_frames = _spec_from_audio(audio, cfg)
        spec = host_spectrogram(padded, cfg.filter_length, cfg.hop_length, cfg.win_length)[None]
        # the first n_frames rows of what `convert` draws for the same seed
        noise = np.random.default_rng(seed).standard_normal((1, n_frames, cfg.inter_channels)).astype(np.float32)
        out = voice_conversion_streaming(
            model, spec[:, :n_frames], np.asarray([n_frames]), self._as_g(src_se), self._as_g(tgt_se),
            float(tau), noise, chunk_frames=chunk_frames, fast=fast,
            dec_cache=self._require_dec_cache() if fast else None,
        )
        audio_out = out[0, : n_frames * cfg.upsample_factor, 0]
        if self.enable_watermark and message:
            audio_out = self.add_watermark(audio_out, message)
        if output_path is None:
            return audio_out
        write_wav(output_path, audio_out, cfg.sampling_rate)
        return None

    def _as_g(self, se) -> torch.Tensor:
        se = np.asarray(se, np.float32)
        if se.ndim == 3:  # [1, gin, 1] reference layout
            se = se[0, :, 0]
        elif se.ndim == 2:
            se = se.reshape(-1)
        return torch.from_numpy(np.ascontiguousarray(se)).to(self.device)[None, None, :]  # [1, 1, gin]

    # -- watermark ----------------------------------------------------------

    def add_watermark(self, audio: np.ndarray, message: str) -> np.ndarray:
        if not self.enable_watermark:
            return audio
        return wm.add_watermark(audio, message)

    def detect_watermark(self, audio: np.ndarray, n_repeat: int) -> str:
        return wm.detect_watermark(audio, n_repeat)


class BaseSpeakerTTS(OpenVoiceBaseClass):
    """V1 text → speech in the stock voices (reference api.py:42-98).

    The text front end (``openvoice_tpu_torch/text``) is host Python; Chinese
    text needs ``jieba``.  The encode (text encoder, duration predictors) runs
    in f32 in both modes; ``fast=True`` decodes in bf16 through the flow and
    decoder kernels."""

    # the reference ships EN/ZH only (api.py:43-46); JA/KO work here because
    # the front end implements the cleaners the reference left undefined
    language_marks = {"english": "EN", "chinese": "ZH", "japanese": "JA", "korean": "KO"}

    def _sentence_tokens(self, text: str, speaker, language: str) -> tuple[list[np.ndarray], int]:
        """Sentence split → cleaners → IPA token ids: (one int32 array a
        sentence, speaker id)."""
        from openvoice_tpu_torch.text import default_symbols, intersperse, text_to_sequence
        from openvoice_tpu_torch.text.split import split_sentence

        mark = self.language_marks.get(language.lower())
        if mark is None:
            raise ValueError(f"language {language} is not supported")
        if self.hps is not None:
            symbols = list(self.hps.symbols)
            cleaners = list(self.hps.data.text_cleaners)
            speaker_id = self.hps.speakers[speaker]
        else:
            symbols = default_symbols
            cleaners = ["cjke_cleaners2"]
            # no speakers map without a config: numeric ids pass through,
            # names (e.g. "default") fall back to id 0, as in the JAX package
            if isinstance(speaker, int):
                speaker_id = speaker
            elif str(speaker).lstrip("-").isdigit():
                speaker_id = int(speaker)
            else:
                speaker_id = 0

        token_seqs = []
        for sentence in split_sentence(text, language_str=mark):
            sentence = re.sub(r"([a-z])([A-Z])", r"\1 \2", sentence)
            seq = text_to_sequence(f"[{mark}]{sentence}[{mark}]", symbols, cleaners)
            if self.cfg.add_blank:
                seq = intersperse(seq, 0)
            token_seqs.append(np.asarray(seq, np.int32))
        return token_seqs, speaker_id

    def _finish(self, pieces: list[np.ndarray], output_path: str | None, speed: float):
        out = _concat_with_gaps(pieces, self.cfg.sampling_rate, speed)
        if output_path is None:
            return out
        write_wav(output_path, out, self.cfg.sampling_rate)
        return None

    @torch.inference_mode()
    def tts(self, text: str, output_path: str | None, speaker, language: str = "English",
            speed: float = 1.0, seed: int = 0, fast: bool = False):
        """Sentence by sentence (reference api.py:73-98).  The noise comes
        from numpy generators spawned from `seed` as in the JAX package, so
        the same seed gives the same audio there, and `tts_batched` gives the
        same audio here."""
        model, cfg, dev = self._require_model(), self.cfg, self.device
        token_seqs, speaker_id = self._sentence_tokens(text, speaker, language)
        noise_rngs = _sentence_noise_rngs(seed, len(token_seqs))
        dec_cache = self._require_dec_cache() if fast else None
        pieces = []
        for tokens, (rng_w, rng_y) in zip(token_seqs, noise_rngs):
            t_bucket = round_up_to_bucket(len(tokens))
            padded = np.zeros((1, t_bucket), np.int32)
            padded[0, : len(tokens)] = tokens
            noise_w = rng_w.standard_normal((1, t_bucket, 2)).astype(np.float32)
            enc = S.tts_encode(model, torch.from_numpy(padded).to(dev), torch.tensor([len(tokens)], device=dev),
                               torch.tensor([speaker_id], device=dev), torch.from_numpy(noise_w).to(dev),
                               noise_scale_w=0.6, length_scale=1.0 / speed, sdp_ratio=0.2)
            fb = round_up_to_bucket(max(int(enc.w_ceil.sum()), 1))
            noise = rng_y.standard_normal((1, fb, cfg.inter_channels)).astype(np.float32)
            audio, y_mask = S.tts_decode(model, enc, fb, torch.from_numpy(noise).to(dev), noise_scale=0.667,
                                         fast=fast, dec_cache=dec_cache)
            y_len = int(y_mask[0, :, 0].sum())
            pieces.append(audio[0, : y_len * cfg.upsample_factor, 0].cpu().numpy())
        return self._finish(pieces, output_path, speed)

    @torch.inference_mode()
    def tts_batched(self, text: str, output_path: str | None, speaker, language: str = "English",
                    speed: float = 1.0, seed: int = 0, fast: bool = False):
        """The sentences as batches: one encode per token bucket, one decode
        per frame bucket (the JAX package's ``tts_batched``).  Each
        sentence's noise is drawn as `tts` draws it, so the audio is the
        same for the same seed."""
        model, cfg, dev = self._require_model(), self.cfg, self.device
        token_seqs, speaker_id = self._sentence_tokens(text, speaker, language)
        n = len(token_seqs)
        if n == 0:
            return self._finish([], output_path, speed)
        noise_rngs = _sentence_noise_rngs(seed, n)
        enc_rows = _encode_rows(model, token_seqs, speaker_id, speed, noise_rngs, dev)
        g_row = model.emb_g.weight[speaker_id][None, :]  # [1, gin]
        pieces: list[np.ndarray | None] = [None] * n
        dec_cache = self._require_dec_cache() if fast else None
        for fb, idxs in frame_groups(enc_rows).items():
            enc = _stack_enc_rows(enc_rows, idxs, g_row)
            noise = np.stack([noise_rngs[i][1].standard_normal((fb, cfg.inter_channels)).astype(np.float32)
                              for i in idxs])
            audio, y_mask = S.tts_decode(model, enc, fb, torch.from_numpy(noise).to(dev), noise_scale=0.667,
                                         fast=fast, dec_cache=dec_cache)
            audio = audio[..., 0].cpu().numpy()
            y_lengths = y_mask[..., 0].sum(dim=-1).to(torch.int64).cpu().numpy()
            for r, i in enumerate(idxs):
                pieces[i] = audio[r, : y_lengths[r] * cfg.upsample_factor]
        return self._finish(pieces, output_path, speed)


# -- fused text → cloned audio (the JAX package's api.py:524-870) ----------------

def _chain_parts(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, src_se, tgt_se, fast: bool):
    """What every fused chain reads from its two models: (tts model, conv
    model, g_src, g_tgt [1, 1, gin], the two serving caches or None)."""
    if tts_model.device != converter.device:
        raise ValueError(f"the TTS runs on {tts_model.device}, the converter on {converter.device}")
    return (tts_model._require_model(), converter._require_model(), converter._as_g(src_se),
            converter._as_g(tgt_se), tts_model._require_dec_cache() if fast else None,
            converter._require_dec_cache() if fast else None)


def _finish_cloned(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, pieces: list[np.ndarray],
                   output_path: str | None, speed: float, message: str):
    """Join the sentences with their gaps, watermark the joined audio once,
    then return it or write it."""
    sr = tts_model.cfg.sampling_rate
    out = _concat_with_gaps(pieces, sr, speed)
    if out.size and converter.enable_watermark and message:
        out = converter.add_watermark(out, message)
    if output_path is None:
        return out
    write_wav(output_path, out, sr)
    return None


def _draw_rows(rngs, idxs, frames: int, channels: int) -> np.ndarray:
    """One standard-normal [frames, channels] draw per sentence in `idxs`,
    from its generator, stacked."""
    return np.stack([rngs[i].standard_normal((frames, channels)).astype(np.float32) for i in idxs])


@torch.inference_mode()
def tts_convert_batched(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, text: str, speaker, src_se,
                        tgt_se, language: str = "English", speed: float = 1.0, tau: float = 0.3, seed: int = 0,
                        message: str = "default", fast: bool = True, output_path: str | None = None):
    """The served TTS → convert chain (reference openvoice_app.py:131-141):
    a bucketed-batch TTS encode, then decode + STFT + conversion with the
    base audio kept on the device, one `S.tts_decode_convert` per frame
    bucket.

    Each sentence is converted on its own (its conversion noise drawn from
    `seed` as the JAX package draws it), then the sentences are joined with
    the reference's 0.05 s ÷ speed gaps and the joined audio is watermarked
    once.  The gaps pass through unconverted; otherwise this equals the
    staged `tts_batched` → `convert`, sentence by sentence."""
    model, conv_model, g_src, g_tgt, tts_cache, conv_cache = _chain_parts(tts_model, converter, src_se,
                                                                          tgt_se, fast)
    token_seqs, speaker_id = tts_model._sentence_tokens(text, speaker, language)
    n = len(token_seqs)
    pieces: list[np.ndarray | None] = [None] * n
    if n:
        noise_rngs = _sentence_noise_rngs(seed, n)
        conv_rngs = _sentence_conv_rngs(seed, n)
        enc_rows = _encode_rows(model, token_seqs, speaker_id, speed, noise_rngs, tts_model.device)
        _decode_convert_groups(model, conv_model, enc_rows, list(range(n)), speaker_id,
                               [r[1] for r in noise_rngs], conv_rngs, g_src, g_tgt, tau, fast, tts_cache,
                               conv_cache, pieces)
    return _finish_cloned(tts_model, converter, pieces, output_path, speed, message)


@torch.inference_mode()
def tts_convert_single_dispatch(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, text: str, speaker,
                                src_se, tgt_se, language: str = "English", speed: float = 1.0, tau: float = 0.3,
                                seed: int = 0, message: str = "default", fast: bool = True,
                                frames_per_token: float = 6.0, output_path: str | None = None,
                                stats: dict | None = None):
    """Text → cloned audio with one host round trip per token bucket: the
    whole encode + durations + decode + STFT + conversion chain runs as one
    `S.tts_synthesize_convert`, the output length capped at
    ``frames_per_token · token_bucket`` frames.  Sentences whose duration
    passes the cap are found from the returned uncapped sums and re-run
    through the two-stage chain (`tts_convert_batched`'s draws): the output
    is never truncated.  The noise is drawn at the cap's shape, so the audio
    differs from the other chains' for the same seed.

    `stats`, when a dict, receives {"sentences", "overflow_sentences"}."""
    model, conv_model, g_src, g_tgt, tts_cache, conv_cache = _chain_parts(tts_model, converter, src_se,
                                                                          tgt_se, fast)
    cfg, ccfg, dev = tts_model.cfg, converter.cfg, tts_model.device
    token_seqs, speaker_id = tts_model._sentence_tokens(text, speaker, language)
    n = len(token_seqs)
    pieces: list[np.ndarray | None] = [None] * n
    overflow: list[int] = []
    if n:
        noise_rngs = _sentence_noise_rngs(seed, n)
        conv_rngs = _sentence_conv_rngs(seed, n)
        groups: dict[int, list[int]] = {}
        for i, seq in enumerate(token_seqs):
            groups.setdefault(round_up_to_bucket(len(seq)), []).append(i)
        for tb, idxs in groups.items():
            m = len(idxs)
            fb = round_up_to_bucket(max(int(tb * frames_per_token), 1))
            toks, lens, noise_w = _pack_token_batch(token_seqs, idxs, tb, noise_rngs)
            noise_dec = _draw_rows([r[1] for r in noise_rngs], idxs, fb, cfg.inter_channels)
            noise_conv = _draw_rows(conv_rngs, idxs, fb, ccfg.inter_channels)
            audio, y_frames, total = S.tts_synthesize_convert(
                model, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                torch.full((m,), speaker_id, device=dev), torch.from_numpy(noise_w).to(dev), fb,
                torch.from_numpy(noise_dec).to(dev), conv_model, g_src.repeat(m, 1, 1), g_tgt.repeat(m, 1, 1),
                float(tau), torch.from_numpy(noise_conv).to(dev), length_scale=1.0 / speed, fast=fast,
                tts_dec_cache=tts_cache, conv_dec_cache=conv_cache,
            )
            audio, y_frames, total = audio[..., 0].cpu().numpy(), y_frames.cpu().numpy(), total.cpu().numpy()
            for r, i in enumerate(idxs):
                if total[r] > fb:
                    overflow.append(i)  # capped: re-run exactly below
                else:
                    pieces[i] = audio[r, : int(y_frames[r]) * cfg.upsample_factor]
        if overflow:
            _two_stage_pieces(model, conv_model, token_seqs, overflow, seed, speaker_id, speed, g_src, g_tgt,
                              tau, fast, tts_cache, conv_cache, pieces)
    if stats is not None:
        stats["sentences"] = n
        stats["overflow_sentences"] = len(overflow)
    return _finish_cloned(tts_model, converter, pieces, output_path, speed, message)


@torch.inference_mode()
def tts_convert_stream(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, text: str, speaker, src_se,
                       tgt_se, language: str = "English", speed: float = 1.0, tau: float = 0.3, seed: int = 0,
                       message: str = "default", fast: bool = True, frames_per_token: float = 6.0):
    """Generator: cloned audio sentence by sentence, each chunk one sentence
    and its trailing gap, watermarked on its own.  The draws are
    `tts_convert_single_dispatch`'s, so with the watermark off the joined
    chunks equal its output; a sentence past the cap falls back as there."""
    model, conv_model, g_src, g_tgt, tts_cache, conv_cache = _chain_parts(tts_model, converter, src_se,
                                                                          tgt_se, fast)
    cfg, ccfg, dev = tts_model.cfg, converter.cfg, tts_model.device
    token_seqs, speaker_id = tts_model._sentence_tokens(text, speaker, language)
    n = len(token_seqs)
    if n == 0:
        return
    noise_rngs = _sentence_noise_rngs(seed, n)
    conv_rngs = _sentence_conv_rngs(seed, n)
    gap = np.zeros(int(cfg.sampling_rate * 0.05 / speed), np.float32)
    for i, seq in enumerate(token_seqs):
        tb = round_up_to_bucket(len(seq))
        fb = round_up_to_bucket(max(int(tb * frames_per_token), 1))
        toks, lens, noise_w = _pack_token_batch(token_seqs, [i], tb, noise_rngs)
        noise_dec = _draw_rows([r[1] for r in noise_rngs], [i], fb, cfg.inter_channels)
        noise_conv = _draw_rows(conv_rngs, [i], fb, ccfg.inter_channels)
        audio, y_frames, total = S.tts_synthesize_convert(
            model, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
            torch.full((1,), speaker_id, device=dev), torch.from_numpy(noise_w).to(dev), fb,
            torch.from_numpy(noise_dec).to(dev), conv_model, g_src, g_tgt, float(tau),
            torch.from_numpy(noise_conv).to(dev), length_scale=1.0 / speed, fast=fast,
            tts_dec_cache=tts_cache, conv_dec_cache=conv_cache,
        )
        if int(total[0]) > fb:
            # the exact two-stage fallback, with fresh generators: the capped
            # call advanced the originals
            piece = _two_stage_pieces(model, conv_model, token_seqs, [i], seed, speaker_id, speed, g_src,
                                      g_tgt, tau, fast, tts_cache, conv_cache, [None] * n)[i]
        else:
            piece = audio[0, : int(y_frames[0]) * cfg.upsample_factor, 0].cpu().numpy()
        chunk = np.concatenate([piece, gap])
        if converter.enable_watermark and message:
            chunk = converter.add_watermark(chunk, message)
        yield chunk


def _decode_convert_groups(model: S.Synthesizer, conv_model: S.Synthesizer, enc_rows: list[dict],
                           sent_ids: list[int], speaker_id: int, dec_rngs, conv_rngs, g_src: torch.Tensor,
                           g_tgt: torch.Tensor, tau: float, fast: bool, tts_cache, conv_cache,
                           pieces: list) -> list:
    """Decode + convert encoded rows (row k is sentence sent_ids[k]) in
    frame-bucket groups, one `S.tts_decode_convert` a group, each sentence's
    noise from its generators (indexed by sentence); fills `pieces` at the
    sentence ids with audio at its true length and returns it."""
    cfg, ccfg = model.cfg, conv_model.cfg
    dev = g_src.device
    g_row = model.emb_g.weight[speaker_id][None, :]
    for fb, ks in frame_groups(enc_rows).items():
        m, ids = len(ks), [sent_ids[k] for k in ks]
        enc = _stack_enc_rows(enc_rows, ks, g_row)
        noise_dec = _draw_rows(dec_rngs, ids, fb, cfg.inter_channels)
        noise_conv = _draw_rows(conv_rngs, ids, fb, ccfg.inter_channels)
        audio, y_mask = S.tts_decode_convert(
            model, enc, fb, torch.from_numpy(noise_dec).to(dev), conv_model, g_src.repeat(m, 1, 1),
            g_tgt.repeat(m, 1, 1), float(tau), torch.from_numpy(noise_conv).to(dev), noise_scale=0.667,
            fast=fast, tts_dec_cache=tts_cache, conv_dec_cache=conv_cache,
        )
        audio = audio[..., 0].cpu().numpy()
        y_lengths = y_mask[..., 0].sum(dim=-1).to(torch.int64).cpu().numpy()
        for r, i in enumerate(ids):
            pieces[i] = audio[r, : y_lengths[r] * cfg.upsample_factor]
    return pieces


def _two_stage_pieces(model: S.Synthesizer, conv_model: S.Synthesizer, token_seqs, sent_ids: list[int],
                      seed: int, speaker_id: int, speed: float, g_src: torch.Tensor, g_tgt: torch.Tensor,
                      tau: float, fast: bool, tts_cache, conv_cache, pieces: list) -> list:
    """The exact two-stage chain (encode, then decode + convert) for the
    given sentences, with fresh generators from `seed`: the overflow
    fallback of `tts_convert_single_dispatch` and `tts_convert_stream`,
    whose draws equal `tts_convert_batched`'s.  Fills `pieces` at the
    sentence ids and returns it."""
    n_total = len(token_seqs)
    fresh_noise = _sentence_noise_rngs(seed, n_total)
    fresh_conv = _sentence_conv_rngs(seed, n_total)
    enc_rows = _encode_rows(model, [token_seqs[i] for i in sent_ids], speaker_id, speed,
                            [fresh_noise[i] for i in sent_ids], g_src.device)
    return _decode_convert_groups(model, conv_model, enc_rows, sent_ids, speaker_id,
                                  [r[1] for r in fresh_noise], fresh_conv, g_src, g_tgt, tau, fast, tts_cache,
                                  conv_cache, pieces)


def frame_groups(enc_rows: list[dict]) -> dict[int, list[int]]:
    """Sentence indices grouped by the frame bucket of their duration sum,
    in first-seen order: one decode a group."""
    groups: dict[int, list[int]] = {}
    for i, row in enumerate(enc_rows):
        total = int(row["w_ceil"].sum())
        groups.setdefault(round_up_to_bucket(max(total, 1)), []).append(i)
    return groups


def _pack_token_batch(token_seqs, idxs, tb, noise_rngs):
    """One token-bucket group's (tokens, lengths, sdp noise) arrays, drawn in
    `tts`'s order."""
    m = len(idxs)
    toks = np.zeros((m, tb), np.int32)
    lens = np.zeros(m, np.int32)
    noise_w = np.zeros((m, tb, 2), np.float32)
    for r, i in enumerate(idxs):
        toks[r, : len(token_seqs[i])] = token_seqs[i]
        lens[r] = len(token_seqs[i])
        noise_w[r] = noise_rngs[i][0].standard_normal((tb, 2)).astype(np.float32)
    return toks, lens, noise_w


def _encode_rows(model: S.Synthesizer, token_seqs, speaker_id: int, speed: float, noise_rngs,
                 device: torch.device) -> list[dict]:
    """The batched encode: sentences grouped by token bucket, one
    `S.tts_encode` a group; per-sentence rows (m_p, logs_p, x_mask, w_ceil
    on the device) in input order."""
    enc_rows: list[dict | None] = [None] * len(token_seqs)
    groups: dict[int, list[int]] = {}
    for i, seq in enumerate(token_seqs):
        groups.setdefault(round_up_to_bucket(len(seq)), []).append(i)
    for tb, idxs in groups.items():
        toks, lens, noise_w = _pack_token_batch(token_seqs, idxs, tb, noise_rngs)
        enc = S.tts_encode(model, torch.from_numpy(toks).to(device), torch.from_numpy(lens).to(device),
                           torch.full((len(idxs),), speaker_id, device=device),
                           torch.from_numpy(noise_w).to(device),
                           noise_scale_w=0.6, length_scale=1.0 / speed, sdp_ratio=0.2)
        for r, i in enumerate(idxs):
            enc_rows[i] = {"m_p": enc.m_p[r], "logs_p": enc.logs_p[r], "x_mask": enc.x_mask[r],
                           "w_ceil": enc.w_ceil[r]}
    return enc_rows


def _stack_enc_rows(enc_rows: list[dict], idxs: list[int], g_row: torch.Tensor) -> S.TTSEncodeOut:
    """One frame-bucket group's rows, zero-padded to a common token length
    (padded tokens have duration 0 and add no frames) and stacked."""
    tb_max = max(enc_rows[i]["m_p"].shape[0] for i in idxs)

    def stacked(key):
        rows = [enc_rows[i][key] for i in idxs]
        return torch.stack([torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, tb_max - a.shape[0]))
                            for a in rows])

    return S.TTSEncodeOut(m_p=stacked("m_p"), logs_p=stacked("logs_p"), x_mask=stacked("x_mask"),
                          w_ceil=stacked("w_ceil"), g=g_row[None].expand(len(idxs), 1, -1).contiguous())


def _sentence_noise_rngs(seed: int, n: int) -> list[tuple[np.random.Generator, np.random.Generator]]:
    """Per-sentence (sdp noise, decode noise) numpy generators, spawned as the
    JAX package spawns them; `tts` and `tts_batched` share them."""
    out = []
    for child in np.random.SeedSequence(seed).spawn(n):
        w_ss, y_ss = child.spawn(2)
        out.append((np.random.default_rng(w_ss), np.random.default_rng(y_ss)))
    return out


def _sentence_conv_rngs(seed: int, n: int) -> list[np.random.Generator]:
    """Per-sentence conversion-noise generators of the fused chains, spawned
    as the JAX package spawns them (a root apart from the TTS draws)."""
    return [np.random.default_rng(ss) for ss in np.random.SeedSequence([seed, 0xC04]).spawn(n)]


def _concat_with_gaps(pieces: list[np.ndarray], sr: int, speed: float) -> np.ndarray:
    """0.05 s ÷ speed of silence after each sentence (api.py:56-63)."""
    gap = np.zeros(int(sr * 0.05 / speed), np.float32)
    out: list[np.ndarray] = []
    for p in pieces:
        out.append(np.asarray(p, np.float32).reshape(-1))
        out.append(gap)
    return np.concatenate(out) if out else np.zeros(0, np.float32)
