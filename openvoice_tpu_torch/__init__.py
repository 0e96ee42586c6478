"""OpenVoice tone-colour conversion, the V1 base-speaker TTS and MeloTTS-English
(V2's base speaker) in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).

The port of ``openvoice_tpu`` (JAX/Pallas), which stays beside it as the
reference.  This package imports neither JAX nor anything of
``openvoice_tpu``: what it needs of the JAX package's host-side modules, it
keeps as its own copy.
"""

from openvoice_tpu_torch.api import BaseSpeakerTTS, ToneColorConverter  # noqa: F401
from openvoice_tpu_torch.config import (  # noqa: F401
    V1_CONVERTER_CONFIG,
    V2_CONVERTER_CONFIG,
    HParams,
    MeloTTSConfig,
    SynthesizerConfig,
    load_hparams,
    melo_tts_en_config,
    v1_base_tts_config,
)
from openvoice_tpu_torch.nn.bert import load_bert_state_dict  # noqa: F401
from openvoice_tpu_torch.pipeline.se_extractor import get_se  # noqa: F401
