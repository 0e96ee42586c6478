"""The port's ``utils.py`` against the JAX package's: the reference's
``openvoice.utils`` names it re-exports (`HParams`, `load_hparams`,
`get_hparams_from_file`, `split_sentence`) give JAX's results, and the
watermark's bit packing round-trips as JAX's does."""

import json

import numpy as np
import pytest

from openvoice_tpu import utils as jutils
from openvoice_tpu_torch import utils as tutils

CONFIG = {
    "_version_": "v2",
    "data": {"sampling_rate": 22050, "filter_length": 1024, "hop_length": 256, "win_length": 1024,
             "n_speakers": 0, "text_cleaners": ["cjke_cleaners2"]},
    "model": {"zero_g": True, "inter_channels": 192, "upsample_rates": [8, 8, 2, 2],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]},
    "speakers": {"default": 0, "whispering": 1},
    "symbols": ["_", ",", ".", "a"],
}
EN = ("Did you ever hear a folk tale about a giant turtle? It carried a whole village on its back, "
      "and nobody noticed for years. Then, one morning, it sneezed! The village slid into the sea; "
      "the fishermen laughed. Short one.")
ZH = ("在这个快速发展的时代，人工智能正在改变我们的生活方式。从智能手机到自动驾驶汽车，科技无处不在！"
      "你觉得未来会怎样？我们应该如何准备？今天天气很好，我们一起去公园散步吧。好的。")


@pytest.mark.parametrize("name", ["load_hparams", "get_hparams_from_file"])
def test_hparams_loaders_match_jax(name, tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(CONFIG))
    ours, theirs = getattr(tutils, name)(str(path)), getattr(jutils, name)(str(path))
    assert isinstance(ours, tutils.HParams) and type(ours).__name__ == type(theirs).__name__
    assert ours.to_dict() == theirs.to_dict() == CONFIG
    assert ours.data.text_cleaners == theirs.data.text_cleaners
    assert ours.speakers["whispering"] == theirs.speakers["whispering"] == 1
    assert ("model" in ours) and ("model" in theirs) and len(ours) == len(theirs)


def test_hparams_from_keywords_match_jax():
    ours, theirs = tutils.HParams(**CONFIG), jutils.HParams(**CONFIG)
    assert ours.to_dict() == theirs.to_dict()
    assert list(ours.keys()) == list(theirs.keys())
    assert ours.get("missing", 7) == theirs.get("missing", 7) == 7


@pytest.mark.parametrize("language,text", [("EN", EN), ("ZH", ZH)])
@pytest.mark.parametrize("min_len", [5, 10])
def test_split_sentence_matches_jax(language, text, min_len):
    ours = tutils.split_sentence(text, min_len=min_len, language_str=language)
    assert ours == jutils.split_sentence(text, min_len=min_len, language_str=language)
    assert len(ours) >= 2


@pytest.mark.parametrize("message", ["@MyShell", "ovt", ""])
def test_bit_packing_matches_jax(message):
    bits = tutils.string_to_bits(message)
    np.testing.assert_array_equal(bits, jutils.string_to_bits(message))
    assert tutils.bits_to_string(bits) == jutils.bits_to_string(bits)
