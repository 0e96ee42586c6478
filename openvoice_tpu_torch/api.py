"""User-facing API of the PyTorch port: `ToneColorConverter` and
`BaseSpeakerTTS`.

Mirrors ``openvoice_tpu/api.py`` and through it the reference surface
(api.py:14-201).  The converter runs end to end in both numeric modes: host
reflect-pad → STFT kernel (``csrc/stft.cu``) → posterior encoder → flow →
decoder → watermark.  ``convert(fast=False)`` is the f32 parity mode on stock
layers; ``convert(fast=True)`` is the bf16 serving mode, whose WaveNet, flow
and decoder stages are hand-written kernels (``csrc/{wn,coupling,mrf,tail}.cu``).
The base-speaker TTS encodes text in f32 and decodes in either mode, the
serving mode through the flow and decoder kernels.  A MeloTTS config (OpenVoice
V2's base speaker) runs the same way, with BERT word features ahead of its
encode and its transformer-coupling flow on stock bf16 layers.  `convert_streaming`
converts audio of any length in fixed windows (``runtime/streaming.py``), and
the fused chains `tts_convert_batched`, `tts_convert_single_dispatch` and
`tts_convert_stream` take text to cloned audio with the base audio kept on
the device.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that, they raise.

On the card each device path runs as one CUDA graph per shape, as the JAX
package runs it as one ``jax.jit`` program per bucket
(``runtime/graphs.py``): `convert` (its ``_jit_convert``), the speaker
embedding of `extract_se` / `extract_se_from_file` (``_jit_tone_color``),
the chunks of `convert_streaming` (its ``_run_chunk``), the text encode
and the decode of `BaseSpeakerTTS.tts` / `tts_batched` (``tts_encode_jit``,
``tts_decode_jit``; for MeloTTS also its BERT, site ``tts_bert``, a graph a
wordpiece bucket), and the fused chains' groups
(``tts_decode_convert_jit``, ``tts_synthesize_convert_jit``).  The first
call of a shape runs eagerly and captures the graph; later calls replay it.
Each instance keeps its graphs in ``self.graphs`` (a TTS model also the
chains' through each converter, `BaseSpeakerTTS.chain_graphs`);
``self.graphs.enabled = False`` runs every call eagerly.

Spans (``runtime/profiler.py::trace``, recorded while a profiler runs): each
public entry is an ``ov.<entry>`` span (``ov.convert``,
``ov.tts_convert_batched``, ...; a generator's one a ``next``), named with its
``fast`` and a request number of the process, and the spans on its thread
inside it are its parts: ``ov.prepare`` (a call's inputs: audio load,
reflect pad and bucket buffer, or a TTS group's tokens and stacked encode
rows), ``ov.noise`` (the host draws), ``ov.text`` (sentence split, cleaners,
g2p, ids), ``ov.bert`` (MeloTTS: a group's wordpieces and each phone's
wordpiece from ``word2ph``), ``ov.readback`` (the host waiting on the card),
``ov.join`` (the sentences and their gaps joined), ``ov.watermark`` and
``GraphCache``'s ``ov.graph.*``.  `BaseSpeakerTTS.tts` and `tts_batched`
raise the ``METRICS`` counters ``tts_true_frames`` and
``tts_decoded_frames`` (rows × frame bucket) once a decode group.
"""

from __future__ import annotations

import functools
import inspect
import itertools
import os
import re
import weakref
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from openvoice_tpu_torch.audio.io import load_audio, write_wav
from openvoice_tpu_torch.audio.stft import host_spectrogram
from openvoice_tpu_torch.ckpt.from_jax import synthesizer_from_jax
from openvoice_tpu_torch.ckpt.native_io import load_npz
from openvoice_tpu_torch.ckpt.torch_import import load_torch_checkpoint
from openvoice_tpu_torch.config import HParams, SynthesizerConfig, load_hparams
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.nn.bert import Bert, BertConfig, init_bert
from openvoice_tpu_torch.ops.stft_cuda import stft_magnitude
from openvoice_tpu_torch.pipeline import watermark as wm
from openvoice_tpu_torch.pipeline.se_extractor import split_audio_vad
from openvoice_tpu_torch.pipeline.whisper_seg import make_segmenter, split_audio_whisper
from openvoice_tpu_torch.runtime.bucketing import round_up_to_bucket
from openvoice_tpu_torch.runtime.graphs import GraphCache, GraphKey
from openvoice_tpu_torch.runtime.profiler import METRICS, profiling, trace
from openvoice_tpu_torch.runtime.streaming import voice_conversion_streaming

# the reference's sampling knobs of tts() (api.py:73-98), as the JAX package
# passes them to tts_encode_jit / tts_decode_jit
NOISE_SCALE = 0.667
NOISE_SCALE_W = 0.6
SDP_RATIO = 0.2
# MeloTTS's (melo/api.py::tts_to_file's defaults; its sdp_ratio is SDP_RATIO)
MELO_NOISE_SCALE = 0.6
MELO_NOISE_SCALE_W = 0.8
# wordpiece buckets of the BERT graphs (bert-base-uncased takes 512 positions)
WORDPIECE_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


_REQUESTS = itertools.count()


def _entry(fn):
    """`fn` as a public entry: while a profiler records, each call (each
    ``next``, for a generator: a chunk, and last the stream's end) is an
    ``ov.<name>`` span named with the call's ``fast``, where it has one,
    and a request number of the process."""
    name = "ov." + fn.__name__
    params = inspect.signature(fn).parameters
    at = list(params).index("fast") if "fast" in params else None

    def span(args, kwargs):
        if not profiling():
            return trace(name)
        named = {"req": next(_REQUESTS)}
        if at is not None:
            named["fast"] = kwargs.get("fast", args[at] if len(args) > at else params["fast"].default)
        return trace(name, args=named)

    if inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def chunks(*args, **kwargs):
            it = fn(*args, **kwargs)
            while True:
                with span(args, kwargs):
                    chunk = next(it, None)
                if chunk is None:
                    return
                yield chunk
        return chunks

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not profiling():
            return fn(*args, **kwargs)
        with span(args, kwargs):
            return fn(*args, **kwargs)
    return call


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
        self.graphs = GraphCache(self.device)  # the CUDA graphs of this instance's calls

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
        self.graphs.clear()     # they read the old tensors

    def _require_model(self) -> S.Synthesizer:
        if self.model is None:
            raise RuntimeError("no weights loaded: call load_ckpt() or init_random()")
        return self.model

    def _require_dec_cache(self) -> dict:
        """The serving mode's packed weights (`S.make_dec_cache`): packed
        once, at the first fast call, and again after new weights."""
        if self._dec_cache is None:
            self._dec_cache = S.make_dec_cache(self._require_model())
            self.graphs.clear()  # a serving graph reads the packed weights it was captured with
        return self._dec_cache


class ToneColorConverter(OpenVoiceBaseClass):
    """Zero-shot tone-colour conversion (reference api.py:101-201)."""

    def __init__(self, config_path: str | None = None, cfg: SynthesizerConfig | None = None, *,
                 device: str | torch.device | None = None, enable_watermark: bool = True):
        super().__init__(config_path, cfg, device=device)
        self.enable_watermark = enable_watermark

    # -- speaker embeddings -------------------------------------------------

    @_entry
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

    @_entry
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
        ses = self.graphs.run(GraphKey("tone_color", bucket=bucket, batch=len(prepared)),
                              partial(tone_color_body, model, cfg), {"audio": batch, "lengths": lengths})
        with trace("ov.readback"):
            return ses.mean(dim=0).cpu().numpy()

    # -- conversion ---------------------------------------------------------

    @_entry
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
        with trace("ov.prepare"):
            if isinstance(audio_src_path, (str, os.PathLike)):
                audio, _ = load_audio(str(audio_src_path), sr=cfg.sampling_rate)
            else:
                audio = np.asarray(audio_src_path, np.float32)
            padded, n_frames = _spec_from_audio(audio, cfg)
            bucket = round_up_to_bucket(n_frames)
            buf = np.zeros((1, (bucket - 1) * cfg.hop_length + cfg.filter_length), np.float32)
            buf[0, : len(padded)] = padded
            inputs = {"audio": buf, "lengths": np.asarray([n_frames], np.int64), "g_src": _g_host(src_se),
                      "g_tgt": _g_host(tgt_se), "tau": np.full((1, 1, 1), tau, np.float32)}
        with trace("ov.noise"):  # host noise, drawn exactly as the JAX package draws it
            inputs["noise"] = np.random.default_rng(seed).standard_normal(
                (1, bucket, cfg.inter_channels)).astype(np.float32)
        body = partial(convert_body, model, cfg, fast, self._require_dec_cache() if fast else None)
        out = self.graphs.run(GraphKey("convert", bucket=bucket, batch=1, fast=fast), body, inputs)
        with trace("ov.readback"):
            audio_out = out[0, : n_frames * cfg.upsample_factor, 0].cpu().numpy()
        if self.enable_watermark and message:
            audio_out = self.add_watermark(audio_out, message)
        if output_path is None:
            return audio_out
        write_wav(output_path, audio_out, cfg.sampling_rate)
        return None

    @_entry
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
        with trace("ov.prepare"):
            if isinstance(audio_src_path, (str, os.PathLike)):
                audio, _ = load_audio(str(audio_src_path), sr=cfg.sampling_rate)
            else:
                audio = np.asarray(audio_src_path, np.float32)
            padded, n_frames = _spec_from_audio(audio, cfg)
            spec = host_spectrogram(padded, cfg.filter_length, cfg.hop_length, cfg.win_length)[None]
        with trace("ov.noise"):  # the first n_frames rows of what `convert` draws for the same seed
            noise = np.random.default_rng(seed).standard_normal((1, n_frames, cfg.inter_channels)).astype(np.float32)
        out = voice_conversion_streaming(
            model, spec[:, :n_frames], np.asarray([n_frames]), _g_host(src_se), _g_host(tgt_se),
            float(tau), noise, chunk_frames=chunk_frames, fast=fast,
            dec_cache=self._require_dec_cache() if fast else None, graphs=self.graphs,
        )
        audio_out = out[0, : n_frames * cfg.upsample_factor, 0]
        if self.enable_watermark and message:
            audio_out = self.add_watermark(audio_out, message)
        if output_path is None:
            return audio_out
        write_wav(output_path, audio_out, cfg.sampling_rate)
        return None

    def _as_g(self, se) -> torch.Tensor:
        """An SE as [1, 1, gin] on this instance's device."""
        return torch.from_numpy(_g_host(se)).to(self.device)

    # -- watermark ----------------------------------------------------------

    def add_watermark(self, audio: np.ndarray, message: str) -> np.ndarray:
        if not self.enable_watermark:
            return audio
        return wm.add_watermark(audio, message)

    def detect_watermark(self, audio: np.ndarray, n_repeat: int) -> str:
        return wm.detect_watermark(audio, n_repeat)


class BaseSpeakerTTS(OpenVoiceBaseClass):
    """V1 text → speech in the stock voices (reference api.py:42-98), or
    MeloTTS's English (melo/api.py::tts_to_file) from a MeloTTS config.

    The text front end (``openvoice_tpu_torch/text``) is host Python; Chinese
    text needs ``jieba``.  The encode (text encoder, duration predictors) runs
    in f32 in both modes; ``fast=True`` decodes in bf16 through the flow and
    decoder kernels.  MeloTTS's encode also takes each phone's BERT feature:
    ``self.bert`` (`nn.bert.Bert`, f32, layers 1-10 of bert-base-uncased; see
    `set_bert`) runs ahead of it, one graph a wordpiece bucket; its flow
    runs on stock bf16 layers with ``fast=True``, its decoder through K3 and
    K4 (``text/melo.py`` says what of MeloTTS's text side is kept)."""

    # the reference ships EN/ZH only (api.py:43-46); JA/KO work here because
    # the front end implements the cleaners the reference left undefined
    language_marks = {"english": "EN", "chinese": "ZH", "japanese": "JA", "korean": "KO"}

    def __init__(self, config_path: str | None = None, cfg: SynthesizerConfig | None = None, *,
                 device: str | torch.device | None = None, bert_cfg: BertConfig | None = None):
        super().__init__(config_path, cfg, device=device)
        self._chain_graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # converter → its chains' graphs
        melo = self.cfg.is_melo
        self.bert_cfg = (bert_cfg or BertConfig()) if melo else None
        self.bert: Bert | None = None
        self.noise_scale = MELO_NOISE_SCALE if melo else NOISE_SCALE
        self.noise_scale_w = MELO_NOISE_SCALE_W if melo else NOISE_SCALE_W

    def init_random(self, seed: int = 0) -> None:
        """Random weights, and for MeloTTS a random BERT (`nn.bert.init_bert`)."""
        super().init_random(seed)
        if self.cfg.is_melo:
            self.set_bert(init_bert(self.bert_cfg, torch.Generator().manual_seed(seed + 1)))

    def set_bert(self, bert: Bert) -> None:
        """Use `bert` (moved to this instance's device) for MeloTTS's word
        features; a bert-base-uncased state dict loads into
        ``Bert(BertConfig())`` with `nn.bert.load_bert_state_dict`."""
        self.bert = bert.to(self.device).eval()
        self.graphs.clear()  # they read the old tensors

    def chain_graphs(self, converter: "ToneColorConverter") -> GraphCache:
        """The graphs of the fused chains from this model through
        `converter` (the JAX package's ``tts_decode_convert_jit`` and
        ``tts_synthesize_convert_jit``).  They read both models: either
        owner's new weights or rebuilt serving cache drops them, and either
        owner's ``graphs.enabled = False`` runs the chains eagerly."""
        if converter not in self._chain_graphs:
            self._chain_graphs[converter] = GraphCache(self.device, reads=(self.graphs, converter.graphs))
        return self._chain_graphs[converter]

    def _sentence_tokens(self, text: str, speaker, language: str) -> tuple[list, int]:
        """Sentence split → cleaners → IPA token ids: (one int32 array a
        sentence, speaker id); for MeloTTS one `text.melo.MeloTokens` a
        piece."""
        from openvoice_tpu_torch.text import default_symbols, intersperse, text_to_sequence
        from openvoice_tpu_torch.text.split import split_sentence

        mark = self.language_marks.get(language.lower())
        if mark is None:
            raise ValueError(f"language {language} is not supported")
        if self.cfg.is_melo:
            return self._melo_tokens(text, speaker, mark)
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
        with trace("ov.text"):
            for sentence in split_sentence(text, language_str=mark):
                sentence = re.sub(r"([a-z])([A-Z])", r"\1 \2", sentence)
                seq = text_to_sequence(f"[{mark}]{sentence}[{mark}]", symbols, cleaners)
                if self.cfg.add_blank:
                    seq = intersperse(seq, 0)
                token_seqs.append(np.asarray(seq, np.int32))
        return token_seqs, speaker_id

    def _melo_tokens(self, text: str, speaker, mark: str) -> tuple[list, int]:
        """MeloTTS's English text side (``text/melo.py``): pieces split as
        melo/split_utils.py splits them, each piece's phones, tones,
        languages, wordpieces and word2ph."""
        from openvoice_tpu_torch.text import melo

        if mark != "EN":
            raise ValueError("the MeloTTS path reads English")
        spk2id = self.hps.data.get("spk2id") if self.hps is not None else None
        if isinstance(speaker, str) and not speaker.lstrip("-").isdigit():
            speaker_id = spk2id[speaker] if spk2id is not None else 0
        else:
            speaker_id = int(speaker)
        with trace("ov.text"):
            rows = [melo.english_tokens(re.sub(r"([a-z])([A-Z])", r"\1 \2", piece), self.cfg.n_vocab,
                                        self.bert_cfg.vocab_size, self.cfg.add_blank)
                    for piece in melo.split_pieces(text)]
        return rows, speaker_id

    def _encode_inputs(self) -> dict:
        """What `_encode_rows` needs of this model: its sampling knobs, and
        for MeloTTS its BERT."""
        if self.cfg.is_melo and self.bert is None:
            raise RuntimeError("no BERT weights: call set_bert() or init_random()")
        return {"noise_scale_w": self.noise_scale_w, "bert": self.bert}

    def _frames_done(self, rows: int, frame_bucket: int, y_lengths) -> None:
        """One decode group's frames: its rows' own and the padded bucket's."""
        METRICS.add_many({"tts_true_frames": float(np.sum(y_lengths)),
                          "tts_decoded_frames": float(rows * frame_bucket)})

    def _finish(self, pieces: list[np.ndarray], output_path: str | None, speed: float):
        out = _concat_with_gaps(pieces, self.cfg.sampling_rate, speed)
        if output_path is None:
            return out
        write_wav(output_path, out, self.cfg.sampling_rate)
        return None

    @_entry
    @torch.inference_mode()
    def tts(self, text: str, output_path: str | None, speaker, language: str = "English",
            speed: float = 1.0, seed: int = 0, fast: bool = False):
        """Sentence by sentence (reference api.py:73-98).  The noise comes
        from numpy generators spawned from `seed` as in the JAX package, so
        the same seed gives the same audio there, and `tts_batched` gives the
        same audio here."""
        model, cfg = self._require_model(), self.cfg
        token_seqs, speaker_id = self._sentence_tokens(text, speaker, language)
        noise_rngs = _sentence_noise_rngs(seed, len(token_seqs))
        dec_cache = self._require_dec_cache() if fast else None
        knobs = self._encode_inputs()
        g_row = model.emb_g.weight[speaker_id][None, :]  # [1, gin]
        pieces = []
        for tokens, (rng_w, rng_y) in zip(token_seqs, noise_rngs):
            enc_rows = _encode_rows(model, [tokens], speaker_id, speed, [(rng_w, rng_y)], self.device,
                                    self.graphs, **knobs)
            with trace("ov.readback"):
                fb = round_up_to_bucket(max(int(enc_rows[0]["w_ceil"].sum()), 1))
            with trace("ov.noise"):
                noise = rng_y.standard_normal((1, fb, cfg.inter_channels)).astype(np.float32)
            audio, y_mask = _tts_decode(self.graphs, model, _stack_enc_rows(enc_rows, [0], g_row), fb, noise, fast,
                                        dec_cache, self.noise_scale)
            with trace("ov.readback"):
                y_len = int(y_mask[0, :, 0].sum())
                pieces.append(audio[0, : y_len * cfg.upsample_factor, 0].cpu().numpy())
            self._frames_done(1, fb, y_len)
        return self._finish(pieces, output_path, speed)

    @_entry
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
        enc_rows = _encode_rows(model, token_seqs, speaker_id, speed, noise_rngs, dev, self.graphs,
                                **self._encode_inputs())
        g_row = model.emb_g.weight[speaker_id][None, :]  # [1, gin]
        pieces: list[np.ndarray | None] = [None] * n
        dec_cache = self._require_dec_cache() if fast else None
        for fb, idxs in frame_groups(enc_rows).items():
            with trace("ov.prepare"):
                enc = _stack_enc_rows(enc_rows, idxs, g_row)
                noise = _draw_rows([r[1] for r in noise_rngs], idxs, fb, cfg.inter_channels)
            audio, y_mask = _tts_decode(self.graphs, model, enc, fb, noise, fast, dec_cache, self.noise_scale)
            with trace("ov.readback"):
                audio = audio[..., 0].cpu().numpy()
                y_lengths = y_mask[..., 0].sum(dim=-1).to(torch.int64).cpu().numpy()
            for r, i in enumerate(idxs):
                pieces[i] = audio[r, : y_lengths[r] * cfg.upsample_factor]
            self._frames_done(len(idxs), fb, y_lengths)
        return self._finish(pieces, output_path, speed)


# -- fused text → cloned audio (the JAX package's api.py:524-870) ----------------

class _Chain(NamedTuple):
    """What every fused chain reads from its two models."""

    model: S.Synthesizer          # the TTS model
    conv_model: S.Synthesizer
    g_src: np.ndarray             # [1, 1, gin] host
    g_tgt: np.ndarray
    fast: bool
    tts_cache: dict | None        # the serving caches, fast=True only
    conv_cache: dict | None
    tts_graphs: GraphCache        # the TTS model's own: its encode graphs
    graphs: GraphCache            # the chains' graphs, which read both models


def _chain_parts(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, src_se, tgt_se, fast: bool) -> _Chain:
    if tts_model.cfg.is_melo:
        raise ValueError("the fused chains take the V1 TTS; run a MeloTTS model's tts / tts_batched, then convert")
    if tts_model.device != converter.device:
        raise ValueError(f"the TTS runs on {tts_model.device}, the converter on {converter.device}")
    return _Chain(tts_model._require_model(), converter._require_model(), _g_host(src_se), _g_host(tgt_se), fast,
                  tts_model._require_dec_cache() if fast else None,
                  converter._require_dec_cache() if fast else None, tts_model.graphs,
                  tts_model.chain_graphs(converter))


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
    with trace("ov.noise"):
        return np.stack([rngs[i].standard_normal((frames, channels)).astype(np.float32) for i in idxs])


def _on_host(out: tuple) -> tuple:
    """A chain's outputs copied to host memory (`GraphCache.run`'s consumer,
    before another replay may overwrite them)."""
    with trace("ov.readback"):
        return tuple(x.cpu() for x in out)


@_entry
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
    chain = _chain_parts(tts_model, converter, src_se, tgt_se, fast)
    token_seqs, speaker_id = tts_model._sentence_tokens(text, speaker, language)
    n = len(token_seqs)
    pieces: list[np.ndarray | None] = [None] * n
    if n:
        noise_rngs = _sentence_noise_rngs(seed, n)
        enc_rows = _encode_rows(chain.model, token_seqs, speaker_id, speed, noise_rngs, tts_model.device,
                                chain.tts_graphs)
        _decode_convert_groups(chain, enc_rows, list(range(n)), speaker_id, [r[1] for r in noise_rngs],
                               _sentence_conv_rngs(seed, n), tau, pieces)
    return _finish_cloned(tts_model, converter, pieces, output_path, speed, message)


@_entry
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
    chain = _chain_parts(tts_model, converter, src_se, tgt_se, fast)
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
            fb = round_up_to_bucket(max(int(tb * frames_per_token), 1))
            audio, y_frames, total = _synthesize_convert(chain, token_seqs, idxs, tb, fb, speaker_id, speed, tau,
                                                         noise_rngs, conv_rngs)
            for r, i in enumerate(idxs):
                if total[r] > fb:
                    overflow.append(i)  # capped: re-run exactly below
                else:
                    pieces[i] = audio[r, : int(y_frames[r]) * chain.model.cfg.upsample_factor]
        if overflow:
            _two_stage_pieces(chain, token_seqs, overflow, seed, speaker_id, speed, tau, pieces)
    if stats is not None:
        stats["sentences"] = n
        stats["overflow_sentences"] = len(overflow)
    return _finish_cloned(tts_model, converter, pieces, output_path, speed, message)


@_entry
@torch.inference_mode()
def tts_convert_stream(tts_model: BaseSpeakerTTS, converter: ToneColorConverter, text: str, speaker, src_se,
                       tgt_se, language: str = "English", speed: float = 1.0, tau: float = 0.3, seed: int = 0,
                       message: str = "default", fast: bool = True, frames_per_token: float = 6.0):
    """Generator: cloned audio sentence by sentence, each chunk one sentence
    and its trailing gap, watermarked on its own.  The draws are
    `tts_convert_single_dispatch`'s, so with the watermark off the joined
    chunks equal its output; a sentence past the cap falls back as there."""
    chain = _chain_parts(tts_model, converter, src_se, tgt_se, fast)
    cfg = chain.model.cfg
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
        audio, y_frames, total = _synthesize_convert(chain, token_seqs, [i], tb, fb, speaker_id, speed, tau,
                                                     noise_rngs, conv_rngs)
        if int(total[0]) > fb:
            # the exact two-stage fallback, with fresh generators: the capped
            # call advanced the originals
            piece = _two_stage_pieces(chain, token_seqs, [i], seed, speaker_id, speed, tau, [None] * n)[i]
        else:
            piece = audio[0, : int(y_frames[0]) * cfg.upsample_factor]
        chunk = np.concatenate([piece, gap])
        if converter.enable_watermark and message:
            chunk = converter.add_watermark(chunk, message)
        yield chunk


def _synthesize_convert(chain: _Chain, token_seqs, idxs: list[int], tb: int, fb: int, speaker_id: int,
                        speed: float, tau: float, noise_rngs, conv_rngs) -> tuple[np.ndarray, ...]:
    """One token-bucket group (the sentences `idxs`) through
    `tts_synthesize_convert_body`, as a replay of the chains' graph of its
    shape → host (audio [m, fb·upsample], decoded frames [m], uncapped
    duration sums [m])."""
    m = len(idxs)
    with trace("ov.prepare"):
        toks, lens, noise_w = _pack_token_batch(token_seqs, idxs, tb, noise_rngs)
        inputs = {"tokens": toks, "lengths": lens, "sid": np.full(m, speaker_id, np.int64), "noise_w": noise_w,
                  "noise_dec": _draw_rows([r[1] for r in noise_rngs], idxs, fb, chain.model.cfg.inter_channels),
                  **_conv_inputs(chain, m, tau), "noise_conv": _draw_rows(conv_rngs, idxs, fb,
                                                                          chain.conv_model.cfg.inter_channels),
                  "noise_scale": np.float32(NOISE_SCALE), "noise_scale_w": np.float32(NOISE_SCALE_W),
                  "length_scale": np.float32(1.0 / speed), "sdp_ratio": np.float32(SDP_RATIO)}
    key = GraphKey("tts_synthesize_convert", bucket=tb, batch=m, fast=chain.fast, max_frames=fb)
    body = partial(tts_synthesize_convert_body, chain.model, chain.conv_model, fb, chain.fast, chain.tts_cache,
                   chain.conv_cache)
    audio, y_frames, total = chain.graphs.run(key, body, inputs, consume=_on_host)
    return audio[..., 0].numpy(), y_frames.numpy(), total.numpy()


def _conv_inputs(chain: _Chain, m: int, tau: float) -> dict:
    """A chain group's conversion inputs: the embeddings and tau, one row
    each of the group's m."""
    return {"g_src": np.repeat(chain.g_src, m, axis=0), "g_tgt": np.repeat(chain.g_tgt, m, axis=0),
            "tau": np.full((m, 1, 1), tau, np.float32)}


def _decode_convert_groups(chain: _Chain, enc_rows: list[dict], sent_ids: list[int], speaker_id: int, dec_rngs,
                           conv_rngs, tau: float, pieces: list) -> list:
    """Decode + convert encoded rows (row k is sentence sent_ids[k]) in
    frame-bucket groups, one `tts_decode_convert_body` a group (a replay of
    the chains' graph of its shape), each sentence's noise from its
    generators (indexed by sentence); fills `pieces` at the sentence ids
    with audio at its true length and returns it."""
    cfg, ccfg = chain.model.cfg, chain.conv_model.cfg
    g_row = chain.model.emb_g.weight[speaker_id][None, :]
    for fb, ks in frame_groups(enc_rows).items():
        m, ids = len(ks), [sent_ids[k] for k in ks]
        with trace("ov.prepare"):
            enc = _stack_enc_rows(enc_rows, ks, g_row)
            inputs = {**enc._asdict(), "noise_dec": _draw_rows(dec_rngs, ids, fb, cfg.inter_channels),
                      **_conv_inputs(chain, m, tau), "noise_conv": _draw_rows(conv_rngs, ids, fb,
                                                                              ccfg.inter_channels),
                      "noise_scale": np.float32(NOISE_SCALE)}
        key = GraphKey("tts_decode_convert", bucket=enc.m_p.shape[1], batch=m, fast=chain.fast, max_frames=fb)
        body = partial(tts_decode_convert_body, chain.model, chain.conv_model, fb, chain.fast, chain.tts_cache,
                       chain.conv_cache)
        audio, y_frames = chain.graphs.run(key, body, inputs, consume=_on_host)
        for r, i in enumerate(ids):
            pieces[i] = audio[r, : int(y_frames[r]) * cfg.upsample_factor, 0].numpy()
    return pieces


def _two_stage_pieces(chain: _Chain, token_seqs, sent_ids: list[int], seed: int, speaker_id: int, speed: float,
                      tau: float, pieces: list) -> list:
    """The exact two-stage chain (encode, then decode + convert) for the
    given sentences, with fresh generators from `seed`: the overflow
    fallback of `tts_convert_single_dispatch` and `tts_convert_stream`,
    whose draws equal `tts_convert_batched`'s.  Fills `pieces` at the
    sentence ids and returns it."""
    n_total = len(token_seqs)
    fresh_noise = _sentence_noise_rngs(seed, n_total)
    enc_rows = _encode_rows(chain.model, [token_seqs[i] for i in sent_ids], speaker_id, speed,
                            [fresh_noise[i] for i in sent_ids], chain.tts_graphs.device, chain.tts_graphs)
    return _decode_convert_groups(chain, enc_rows, sent_ids, speaker_id, [r[1] for r in fresh_noise],
                                  _sentence_conv_rngs(seed, n_total), tau, pieces)


def frame_groups(enc_rows: list[dict]) -> dict[int, list[int]]:
    """Sentence indices grouped by the frame bucket of their duration sum,
    in first-seen order: one decode a group.  Each sum waits for the card."""
    groups: dict[int, list[int]] = {}
    with trace("ov.readback"):
        for i, row in enumerate(enc_rows):
            total = int(row["w_ceil"].sum())
            groups.setdefault(round_up_to_bucket(max(total, 1)), []).append(i)
    return groups


def _phones(seq) -> np.ndarray:
    """A sentence's token ids: the array itself, or a MeloTTS row's phones."""
    return seq.phones if hasattr(seq, "phones") else seq


def _pack_token_batch(token_seqs, idxs, tb, noise_rngs):
    """One token-bucket group's (tokens, lengths, sdp noise) arrays, drawn in
    `tts`'s order."""
    m = len(idxs)
    toks = np.zeros((m, tb), np.int32)
    lens = np.zeros(m, np.int32)
    noise_w = np.zeros((m, tb, 2), np.float32)
    with trace("ov.noise"):
        for r, i in enumerate(idxs):
            seq = _phones(token_seqs[i])
            toks[r, : len(seq)] = seq
            lens[r] = len(seq)
            noise_w[r] = noise_rngs[i][0].standard_normal((tb, 2)).astype(np.float32)
    return toks, lens, noise_w


def bert_body(bert: Bert, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """MeloTTS's BERT features of a padded wordpiece batch → [B, W, hidden]."""
    return bert(ids, lengths)


def _melo_inputs(graphs: GraphCache, bert: Bert, rows, idxs: list[int], tb: int) -> tuple[dict, int]:
    """A token-bucket group's MeloTTS inputs: tones, languages, the BERT
    features of its wordpieces (a replay of the group's ``tts_bert`` graph)
    and each phone's wordpiece → (the encode's extra inputs, the wordpiece
    bucket)."""
    from openvoice_tpu_torch.text.melo import phone_word_index

    m = len(idxs)
    with trace("ov.bert"):
        wb = round_up_to_bucket(max(len(rows[i].wordpieces) for i in idxs), WORDPIECE_BUCKETS)
        ids, wlens = np.zeros((m, wb), np.int32), np.zeros(m, np.int64)
        tones, langs, index = (np.zeros((m, tb), np.int32), np.zeros((m, tb), np.int32),
                               np.zeros((m, tb), np.int64))
        for r, i in enumerate(idxs):
            row = rows[i]
            ids[r, : len(row.wordpieces)] = row.wordpieces
            wlens[r] = len(row.wordpieces)
            tones[r, : len(row.tones)] = row.tones
            langs[r, : len(row.languages)] = row.languages
            index[r] = phone_word_index(row.word2ph, tb)
    feats = graphs.run(GraphKey("tts_bert", bucket=wb, batch=m), partial(bert_body, bert),
                       {"ids": ids, "lengths": wlens})
    return {"tones": tones, "languages": langs, "bert": feats, "word_index": index}, wb


def _encode_rows(model: S.Synthesizer, token_seqs, speaker_id: int, speed: float, noise_rngs,
                 device: torch.device, graphs: GraphCache | None = None, noise_scale_w: float = NOISE_SCALE_W,
                 bert: Bert | None = None) -> list[dict]:
    """The batched encode: sentences grouped by token bucket, one
    `S.tts_encode` a group (a replay of `graphs`' graph of the group's shape
    where given, else eager; MeloTTS's rows after their BERT); per-sentence
    rows (m_p, logs_p, x_mask, w_ceil on the device) in input order."""
    graphs = GraphCache(device, enabled=False) if graphs is None else graphs
    enc_rows: list[dict | None] = [None] * len(token_seqs)
    groups: dict[int, list[int]] = {}
    for i, seq in enumerate(token_seqs):
        groups.setdefault(round_up_to_bucket(len(_phones(seq))), []).append(i)
    for tb, idxs in groups.items():
        with trace("ov.prepare"):
            toks, lens, noise_w = _pack_token_batch(token_seqs, idxs, tb, noise_rngs)
        extra, wb = _melo_inputs(graphs, bert, token_seqs, idxs, tb) if bert is not None else ({}, None)
        enc = _tts_encode(graphs, model, toks, lens.astype(np.int64), np.full(len(idxs), speaker_id, np.int64),
                          noise_w, speed, noise_scale_w, extra, wb)
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


def _g_host(se) -> np.ndarray:
    """An SE ([1, gin, 1] reference layout, [gin] or [1, gin]) as a float32
    [1, 1, gin] host array."""
    se = np.asarray(se, np.float32)
    if se.ndim == 3:  # [1, gin, 1] reference layout
        se = se[0, :, 0]
    return np.ascontiguousarray(se.reshape(1, 1, -1))


# -- the bodies of the CUDA graphs (runtime/graphs.py): tensors in, tensors out --

def convert_body(model: S.Synthesizer, cfg: SynthesizerConfig, fast: bool, dec_cache: dict | None,
                 audio: torch.Tensor, lengths: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor,
                 tau: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """`convert`'s device path, the JAX package's ``_jit_convert``: the STFT
    kernel on reflect-padded audio [B, L], then `S.voice_conversion` (tau
    [B, 1, 1]) → audio [B, T·upsample, 1]."""
    spec = stft_magnitude(audio, cfg.filter_length, cfg.hop_length, cfg.win_length)
    out, _ = S.voice_conversion(model, spec, lengths, g_src, g_tgt, tau, noise, fast=fast, dec_cache=dec_cache)
    return out


def tone_color_body(model: S.Synthesizer, cfg: SynthesizerConfig, audio: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """The speaker embedding of a padded batch (the STFT kernel, then the
    JAX package's ``_jit_tone_color``) → [B, gin]."""
    spec = stft_magnitude(audio, cfg.filter_length, cfg.hop_length, cfg.win_length)
    return S.extract_tone_color(model, spec, lengths)


def tts_encode_body(model: S.Synthesizer, tokens: torch.Tensor, lengths: torch.Tensor, sid: torch.Tensor,
                    noise_w: torch.Tensor, noise_scale_w: torch.Tensor, length_scale: torch.Tensor,
                    sdp_ratio: torch.Tensor, tones: torch.Tensor | None = None,
                    languages: torch.Tensor | None = None, bert: torch.Tensor | None = None,
                    word_index: torch.Tensor | None = None) -> tuple:
    """`S.tts_encode` with its sampling knobs as tensors (``tts_encode_jit``)
    → the fields of `S.TTSEncodeOut`.  MeloTTS's rows also take tones,
    languages, the BERT features of their wordpieces [B, W, 768] and each
    phone's wordpiece [B, T_x], whose feature the phone takes."""
    ja_bert = None
    if bert is not None:
        ja_bert = torch.gather(bert, 1, word_index[..., None].expand(-1, -1, bert.shape[2]))
    return tuple(S.tts_encode(model, tokens, lengths, sid, noise_w, noise_scale_w=noise_scale_w,
                              length_scale=length_scale, sdp_ratio=sdp_ratio, tones=tones, languages=languages,
                              ja_bert=ja_bert))


def tts_decode_body(model: S.Synthesizer, max_frames: int, fast: bool, dec_cache: dict | None,
                    m_p: torch.Tensor, logs_p: torch.Tensor, x_mask: torch.Tensor, w_ceil: torch.Tensor,
                    g: torch.Tensor, noise: torch.Tensor, noise_scale: torch.Tensor) -> tuple:
    """`S.tts_decode` of an encode's fields (``tts_decode_jit``) → (audio,
    y_mask)."""
    enc = S.TTSEncodeOut(m_p=m_p, logs_p=logs_p, x_mask=x_mask, w_ceil=w_ceil, g=g)
    return S.tts_decode(model, enc, max_frames, noise, noise_scale=noise_scale, fast=fast, dec_cache=dec_cache)


def tts_decode_convert_body(model: S.Synthesizer, conv_model: S.Synthesizer, max_frames: int, fast: bool,
                            tts_cache: dict | None, conv_cache: dict | None, m_p: torch.Tensor,
                            logs_p: torch.Tensor, x_mask: torch.Tensor, w_ceil: torch.Tensor, g: torch.Tensor,
                            noise_dec: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor, tau: torch.Tensor,
                            noise_conv: torch.Tensor, noise_scale: torch.Tensor) -> tuple:
    """`S.tts_decode_convert` of an encode's fields (``tts_decode_convert_jit``:
    static max_frames and fast, tau [B, 1, 1] and noise_scale traced) →
    (converted audio [B, max_frames·upsample, 1], decoded frames [B]
    int32)."""
    enc = S.TTSEncodeOut(m_p=m_p, logs_p=logs_p, x_mask=x_mask, w_ceil=w_ceil, g=g)
    audio, y_mask = S.tts_decode_convert(model, enc, max_frames, noise_dec, conv_model, g_src, g_tgt, tau,
                                         noise_conv, noise_scale=noise_scale, fast=fast, tts_dec_cache=tts_cache,
                                         conv_dec_cache=conv_cache)
    return audio, y_mask[..., 0].sum(dim=-1).to(torch.int32)


def tts_synthesize_convert_body(model: S.Synthesizer, conv_model: S.Synthesizer, max_frames: int, fast: bool,
                                tts_cache: dict | None, conv_cache: dict | None, tokens: torch.Tensor,
                                lengths: torch.Tensor, sid: torch.Tensor, noise_w: torch.Tensor,
                                noise_dec: torch.Tensor, g_src: torch.Tensor, g_tgt: torch.Tensor,
                                tau: torch.Tensor, noise_conv: torch.Tensor, noise_scale: torch.Tensor,
                                noise_scale_w: torch.Tensor, length_scale: torch.Tensor,
                                sdp_ratio: torch.Tensor) -> tuple:
    """`S.tts_synthesize_convert` with every sampling knob a tensor
    (``tts_synthesize_convert_jit``) → (converted audio, decoded frames [B],
    uncapped duration sums [B])."""
    return S.tts_synthesize_convert(model, tokens, lengths, sid, noise_w, max_frames, noise_dec, conv_model, g_src,
                                    g_tgt, tau, noise_conv, noise_scale=noise_scale, noise_scale_w=noise_scale_w,
                                    length_scale=length_scale, sdp_ratio=sdp_ratio, fast=fast,
                                    tts_dec_cache=tts_cache, conv_dec_cache=conv_cache)


def _tts_encode(graphs: GraphCache, model: S.Synthesizer, tokens: np.ndarray, lengths: np.ndarray,
                sids: np.ndarray, noise_w: np.ndarray, speed: float, noise_scale_w: float = NOISE_SCALE_W,
                extra: dict | None = None, wordpieces: int | None = None) -> S.TTSEncodeOut:
    """One token-bucket batch's encode through `graphs` (`extra`: MeloTTS's
    inputs, from BERT features of `wordpieces` rows)."""
    inputs = {"tokens": tokens, "lengths": lengths, "sid": sids, "noise_w": noise_w,
              "noise_scale_w": np.float32(noise_scale_w), "length_scale": np.float32(1.0 / speed),
              "sdp_ratio": np.float32(SDP_RATIO), **(extra or {})}
    key = GraphKey("tts_encode", bucket=tokens.shape[1], batch=tokens.shape[0], wordpieces=wordpieces)
    return S.TTSEncodeOut(*graphs.run(key, partial(tts_encode_body, model), inputs))


def _tts_decode(graphs: GraphCache, model: S.Synthesizer, enc: S.TTSEncodeOut, max_frames: int,
                noise: np.ndarray, fast: bool, dec_cache: dict | None,
                noise_scale: float = NOISE_SCALE) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame-bucket group's decode through `graphs` → (audio, y_mask)."""
    inputs = {**enc._asdict(), "noise": noise, "noise_scale": np.float32(noise_scale)}
    key = GraphKey("tts_decode", bucket=enc.m_p.shape[1], batch=enc.m_p.shape[0], fast=fast, max_frames=max_frames)
    return graphs.run(key, partial(tts_decode_body, model, max_frames, fast, dec_cache), inputs)


def _sentence_noise_rngs(seed: int, n: int) -> list[tuple[np.random.Generator, np.random.Generator]]:
    """Per-sentence (sdp noise, decode noise) numpy generators, spawned as the
    JAX package spawns them; `tts` and `tts_batched` share them."""
    out = []
    with trace("ov.noise"):
        for child in np.random.SeedSequence(seed).spawn(n):
            w_ss, y_ss = child.spawn(2)
            out.append((np.random.default_rng(w_ss), np.random.default_rng(y_ss)))
    return out


def _sentence_conv_rngs(seed: int, n: int) -> list[np.random.Generator]:
    """Per-sentence conversion-noise generators of the fused chains, spawned
    as the JAX package spawns them (a root apart from the TTS draws)."""
    with trace("ov.noise"):
        return [np.random.default_rng(ss) for ss in np.random.SeedSequence([seed, 0xC04]).spawn(n)]


def _concat_with_gaps(pieces: list[np.ndarray], sr: int, speed: float) -> np.ndarray:
    """0.05 s ÷ speed of silence after each sentence (api.py:56-63)."""
    with trace("ov.join"):
        gap = np.zeros(int(sr * 0.05 / speed), np.float32)
        out: list[np.ndarray] = []
        for p in pieces:
            out.append(np.asarray(p, np.float32).reshape(-1))
            out.append(gap)
        return np.concatenate(out) if out else np.zeros(0, np.float32)
