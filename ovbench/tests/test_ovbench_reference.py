"""The plain reference agrees with the port on the CPU at a tiny size, for
each configuration: the converter in f32 on a bucket-padded batch against
the reference at the true length, and the TTS's durations and decode."""

import numpy as np
import pytest
import torch

from ovbench.reference import model as R
from ovbench.tests.tiny import CONVERTER, TTS
from ovbench.weights import make_weights, reference_model

CPU = torch.device("cpu")


def port_and_reference(fields, seed, gain=30.0):
    from ovbench.drivers import port_model

    cfg = R.Config.from_dict(fields)
    w = make_weights(cfg, seed, CPU, gain)
    return port_model(fields, w, CPU), reference_model(cfg, w)


@pytest.mark.parametrize("zero_g", [True, False], ids=["v2", "v1"])
def test_converter_matches_port_at_true_length(zero_g):
    from openvoice_tpu_torch.models import synthesizer as S

    fields = dict(CONVERTER, zero_g=zero_g)
    port, ref = port_and_reference(fields, 3)
    rng = np.random.default_rng(0)
    lengths, bucket = [37, 23], 48
    spec = torch.from_numpy(rng.random((2, bucket, 65)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, bucket, 32)).astype(np.float32))
    g = torch.from_numpy((0.3 * rng.standard_normal((4, 32))).astype(np.float32))
    with torch.no_grad():
        out, _ = S.voice_conversion(port, spec, torch.tensor(lengths), g[:2, None], g[2:, None],
                                    torch.full((2, 1, 1), 0.3), noise)
        for b, n in enumerate(lengths):
            want = R.convert(ref, spec[b, :n], g[b], g[2 + b], 0.3, noise[b, :n])
            got = out[b, : n * 16, 0]
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-7


def test_spectrogram_matches_port():
    from openvoice_tpu_torch.audio.stft import linear_spectrogram

    cfg = R.Config.from_dict(CONVERTER)
    audio = torch.from_numpy(np.random.default_rng(1).standard_normal(2000).astype(np.float32) * 0.1)
    want = linear_spectrogram(audio[None], cfg.filter_length, cfg.hop_length, cfg.win_length)[0].t()
    got = R.spectrogram(audio, cfg)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_tts_matches_port():
    from openvoice_tpu_torch.models import synthesizer as S

    port, ref = port_and_reference(TTS, 4)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(1, 87, 21).astype(np.int64))
    noise_w = torch.from_numpy(rng.standard_normal((21, 2)).astype(np.float32))
    with torch.no_grad():
        enc = S.tts_encode(port, tokens[None], torch.tensor([21]), torch.tensor([2]), noise_w[None])
        m_p, logs_p, w, g = R.tts_durations(ref, tokens, 2, noise_w)
        assert torch.equal(torch.ceil(w), enc.w_ceil[0])
        assert float((m_p - enc.m_p[0]).abs().max()) <= 1e-5
        t_y = int(enc.w_ceil.sum())
        noise = torch.from_numpy(rng.standard_normal((1, t_y, 32)).astype(np.float32))
        audio, _ = S.tts_decode(port, enc, t_y, noise)
        want = R.tts_decode(ref, R.tts_latents(m_p, logs_p, torch.ceil(w), noise[0]), g)
        assert float((audio[0, :, 0] - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-7


@pytest.mark.parametrize("name", ["v2_converter", "v2_converter_f32", "v1_tts_converter"])
def test_published_widths_share_the_checkpoint_layout(name):
    import json
    from pathlib import Path

    from openvoice_tpu_torch.models import synthesizer as S

    from ovbench.drivers import port_config

    config = json.loads((Path(R.__file__).parent.parent / "configs" / f"{name}.json").read_text())
    for key in ("model", "tts", "converter"):
        if key in config:
            with torch.device("meta"):
                a = R.Synthesizer(R.Config.from_dict(config[key])).state_dict()
                b = S.Synthesizer(port_config(config[key])).state_dict()
            assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}
