"""The port's copy of the text front end (``openvoice_tpu_torch/text``)
against the JAX package's: the same sentences give the same sentence splits
and the same token ids, exactly, in every language the front end serves."""

import numpy as np
import pytest

from openvoice_tpu import text as jtext
from openvoice_tpu.api import BaseSpeakerTTS as JaxTTS
from openvoice_tpu.text.split import split_sentence as jsplit
from openvoice_tpu_torch import text as ttext
from openvoice_tpu_torch.api import BaseSpeakerTTS
from openvoice_tpu_torch.text.split import split_sentence as tsplit
from tests._torch_port import TINY_TTS_TAIL, jax_cfg, torch_cfg

CLEANERS = ["cjke_cleaners2"]

SENTENCES = {
    "EN": ("Dr. Smith paid $3.50 for 2 coffees on March 3rd, didn't he? "
           "The quick brown fox jumps over the lazy dog while everyone watches quietly. "
           "OpenVoice clones a voice from only a few seconds of reference audio."),
    "JA": "こんにちは、今日はいい天気ですね。私は学生です。東京に行きたいです。",
    "KO": "안녕하세요, 만나서 반갑습니다. 오늘 날씨가 좋네요. 저는 학생입니다.",
    "ZH": "你好，今天天气很好。我们一起去公园散步吧！这是一个测试句子，包含数字123。",
}


def _check_language(mark: str) -> None:
    text = SENTENCES[mark]
    pieces = tsplit(text, language_str=mark)
    assert pieces == jsplit(text, language_str=mark)
    assert pieces, "no sentence came out"
    for piece in pieces:
        tagged = f"[{mark}]{piece}[{mark}]"
        ids = ttext.text_to_sequence(tagged, ttext.default_symbols, CLEANERS)
        assert ids, f"{piece!r} gave no tokens"
        assert ids == jtext.text_to_sequence(tagged, jtext.default_symbols, CLEANERS)
        assert ttext.intersperse(ids, 0) == jtext.intersperse(ids, 0)


@pytest.mark.parametrize("mark", ["EN", "JA", "KO"])
def test_split_and_token_ids_equal_jax(mark):
    assert ttext.default_symbols == jtext.default_symbols
    _check_language(mark)


def test_split_and_token_ids_equal_jax_chinese():
    pytest.importorskip("jieba")
    _check_language("ZH")


@pytest.mark.parametrize("language", ["English", "Japanese", "Korean"])
def test_tts_sentence_tokens_equal_jax(language):
    """`BaseSpeakerTTS._sentence_tokens`: the split, the camel-case spacing,
    the language marks and the blank interleave, as the JAX class builds them
    (no weights needed)."""
    mark = BaseSpeakerTTS.language_marks[language.lower()]
    text = SENTENCES[mark].replace("coffees", "coffeeCups")
    ours, sid = BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")._sentence_tokens(text, "2", language)
    theirs, jsid = JaxTTS(cfg=jax_cfg(TINY_TTS_TAIL))._sentence_tokens(text, "2", language)
    assert sid == jsid == 2
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not supported"):
        BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")._sentence_tokens(text, 0, "Klingon")
