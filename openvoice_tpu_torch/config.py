"""Configuration: the reference's per-checkpoint ``config.json`` as an
attribute dict (:class:`HParams`) and the static architecture config the
port's modules are built from (:class:`SynthesizerConfig`), with presets for
the released V1/V2 checkpoints.

The port's own copy of ``openvoice_tpu/config.py`` (same names, same
fields), so that the PyTorch package never imports the JAX one.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


class HParams:
    """Recursive attribute-dict, JSON-compatible with the reference config files."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, HParams) else v
        return out

    def __len__(self) -> int:
        return len(self.__dict__)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> Any:
        return setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:
        return repr(self.__dict__)


def load_hparams(config_path: str) -> HParams:
    """Load a reference-format ``config.json`` (utils.py:6-12 behavior)."""
    with open(config_path, "r", encoding="utf-8") as f:
        return HParams(**json.load(f))


@dataclasses.dataclass(frozen=True)
class SynthesizerConfig:
    """Static architecture config for the VITS-style synthesizer.

    Field meanings follow the reference ctor (models.py:404-425); values for the
    released checkpoints ship as presets below.  ``spec_channels`` is always
    ``filter_length // 2 + 1`` (api.py:25).
    """

    # text path (only used when n_speakers > 0)
    n_vocab: int = 0
    # core
    spec_channels: int = 513
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    n_speakers: int = 0
    gin_channels: int = 256
    zero_g: bool = False
    # fixed sub-model hyperparameters (models.py:438-463)
    enc_q_kernel_size: int = 5
    enc_q_layers: int = 16
    flow_kernel_size: int = 5
    flow_wn_layers: int = 4
    flow_n_flows: int = 4
    sdp_filter_channels: int = 192
    sdp_kernel_size: int = 3
    sdp_n_flows: int = 4
    dp_filter_channels: int = 256
    dp_kernel_size: int = 3
    # attention
    attn_window_size: int = 4
    # data
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    add_blank: bool = True

    def __post_init__(self) -> None:
        if len(self.resblock_kernel_sizes) != len(self.resblock_dilation_sizes):
            raise ValueError(
                "resblock_kernel_sizes and resblock_dilation_sizes must have "
                f"equal length, got {len(self.resblock_kernel_sizes)} vs "
                f"{len(self.resblock_dilation_sizes)}"
            )
        if len(self.upsample_rates) != len(self.upsample_kernel_sizes):
            raise ValueError("upsample_rates and upsample_kernel_sizes length mismatch")

    @property
    def upsample_factor(self) -> int:
        f = 1
        for u in self.upsample_rates:
            f *= u
        return f

    @property
    def has_text_path(self) -> bool:
        return self.n_speakers > 0

    # whether the text path is MeloTTS's (`MeloTTSConfig`: tones, languages,
    # BERT, a transformer-coupling flow)
    is_melo = False

    @staticmethod
    def from_hparams(hps: HParams, n_symbols: int | None = None) -> "SynthesizerConfig":
        """Build from a reference-format config (mirrors api.py:23-28 splat).

        A MeloTTS ``config.json`` (top-level ``num_tones``; melo/models.py
        SynthesizerTrn's arguments) gives a `MeloTTSConfig`: its tone and
        language tables and ``model.n_layers_trans_flow``.  Every published
        MeloTTS config conditions the encoder on the speaker and builds the
        transformer-coupling flow, the only ones the port builds; a config
        that sets ``use_transformer_flow`` or ``use_spk_conditioned_encoder``
        false is refused."""
        model: Mapping[str, Any] = hps.model.to_dict() if isinstance(hps.model, HParams) else dict(hps.model)
        data = hps.data
        if n_symbols is None:
            n_symbols = len(hps.get("symbols", []) or [])
        known = {f.name for f in dataclasses.fields(SynthesizerConfig)}
        kwargs = {k: v for k, v in model.items() if k in known}
        cls = SynthesizerConfig
        if "num_tones" in hps:
            cls = MeloTTSConfig
            for key in ("use_transformer_flow", "use_spk_conditioned_encoder"):  # melo/models.py's defaults: on
                if not model.get(key, True):
                    raise ValueError(f"a MeloTTS config with {key} false is not supported")
            kwargs.update(num_tones=int(hps.num_tones), num_languages=int(hps.num_languages))
            kwargs.update({k: v for k, v in model.items() if k == "n_layers_trans_flow"})
        # tolerate extra model keys like the reference's **kwargs (models.py:424)
        kwargs.update(
            n_vocab=n_symbols,
            spec_channels=data.filter_length // 2 + 1,
            n_speakers=data.n_speakers,
            sampling_rate=data.sampling_rate,
            filter_length=data.filter_length,
            hop_length=data.hop_length,
            win_length=data.win_length,
            add_blank=bool(data.get("add_blank", True)),
        )
        # sequences → tuples so the dataclass stays hashable
        for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            if k in kwargs:
                kwargs[k] = tuple(kwargs[k])
        if "resblock_dilation_sizes" in kwargs:
            kwargs["resblock_dilation_sizes"] = tuple(tuple(d) for d in kwargs["resblock_dilation_sizes"])
        return cls(**kwargs)


# ---------------------------------------------------------------------------
# Presets (match the released OpenVoice checkpoint config.json files).
# ---------------------------------------------------------------------------

# V1 tone-color converter: n_speakers=0 → builds the reference encoder path.
V1_CONVERTER_CONFIG = SynthesizerConfig(n_speakers=0, zero_g=False)

# V2 tone-color converter: zero_g=True (models.py:465,495,498 semantics).
V2_CONVERTER_CONFIG = SynthesizerConfig(n_speakers=0, zero_g=True)


def v1_base_tts_config(n_vocab: int, n_speakers: int = 10) -> SynthesizerConfig:
    """V1 base speaker TTS: text path + speaker-style embedding table."""
    return SynthesizerConfig(n_vocab=n_vocab, n_speakers=n_speakers, zero_g=False)


@dataclasses.dataclass(frozen=True)
class MeloTTSConfig(SynthesizerConfig):
    """MeloTTS's synthesizer (melo/models.py SynthesizerTrn): the base
    fields, and the text path's tone and language tables, the widths of the
    two BERT feature inputs (``bert`` 1024, zeros for English; ``ja_bert``
    768, bert-base-uncased's layer 10), the speaker added before the text
    encoder's layer 2 (where gin_channels > 0), and the flow of transformer
    couplings (`nn.extras.TransformerCouplingBlock`, each a
    relative-attention encoder of `n_layers_trans_flow` layers over the
    frames, FFN kernel flow_kernel_size).  The base class keeps the JAX
    package's fields alone."""

    num_tones: int = 16
    num_languages: int = 10
    bert_channels: int = 1024
    ja_bert_channels: int = 768
    n_layers_trans_flow: int = 3

    is_melo = True


# melo/text/symbols.py: the length of the ``symbols`` list MeloTTS's
# config.json carries (table rows only, no width)
MELO_N_SYMBOLS = 219


def melo_tts_en_config(n_vocab: int = MELO_N_SYMBOLS) -> MeloTTSConfig:
    """MeloTTS-English (its config.json; melo/models.py SynthesizerTrn): the
    V1 TTS's widths with tone (16) and language (10) tables, BERT features,
    a speaker-conditioned text encoder, a transformer-coupling flow of 4 ×
    3 attention layers, and a five-stage HiFi-GAN at 44.1 kHz (hop 512)."""
    return MeloTTSConfig(
        n_vocab=n_vocab, n_speakers=256, zero_g=False, spec_channels=1025,
        upsample_rates=(8, 8, 2, 2, 2), upsample_kernel_sizes=(16, 16, 8, 2, 2),
        sampling_rate=44100, filter_length=2048, hop_length=512, win_length=2048,
    )
