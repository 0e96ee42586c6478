"""The port's command-line tools (``openvoice_tpu_torch/tools.py``), each
subcommand called in process with ``--device cpu``: ``convert-ckpt`` of a
reference-format ``.pth`` (weight-normed convs, a numpy scalar entry) and
the directory it writes loaded by ``serve --ckpt``, whose /convert equals the
in-process convert; ``train`` with checkpoints; ``extract-se`` against the
API; and each subcommand raising without CUDA unless the CPU is named."""

import base64
import json
import re
import urllib.request

import numpy as np
import pytest
import torch

from openvoice_tpu_torch import tools
from openvoice_tpu_torch.api import ToneColorConverter
from openvoice_tpu_torch.audio.io import load_audio, write_wav
from openvoice_tpu_torch.ckpt import native_io as CIO
from openvoice_tpu_torch.models.synthesizer import Synthesizer
from tests._torch_port import TINY_API, write_reference_checkpoint

WIRE_TOL = 3e-4  # the JAX suite's bar across the batcher's int16 wire (tests/test_serve.py)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A reference-format config.json and checkpoint of TINY_API (the
    decoder's conv_post scaled ×100, so that the audio stands well above the
    int16 wire's step), and a 0.5 s wav."""
    root = tmp_path_factory.mktemp("tools")
    write_reference_checkpoint(root, TINY_API, seed=4)
    wav = str(root / "src.wav")
    write_wav(wav, (np.random.default_rng(0).standard_normal(11025) * 0.1).astype(np.float32), 22050)
    return root, wav


def _args(root, *extra) -> list[str]:
    return ["--config", str(root / "config.json"), "--device", "cpu", *extra]


def test_convert_ckpt_then_serve_answers_as_the_api(files, monkeypatch, capsys):
    root, wav = files
    assert tools.main(["convert-ckpt", str(root / "ckpt.pth"), str(root / "converted"), *_args(root)]) == 0
    tc = ToneColorConverter(config_path=str(root / "config.json"), device="cpu")
    assert tc.load_ckpt(str(root / "ckpt.pth")) == {"missing": [], "unexpected": []}
    back = CIO.load_checkpoint(str(root / "converted"), template=Synthesizer(tc.cfg))
    for key, value in tc.model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key

    rng = np.random.default_rng(1)
    src, tgt = (rng.standard_normal(TINY_API["gin_channels"]).astype(np.float32) for _ in range(2))
    direct = tc.convert(load_audio(wav, sr=22050)[0], src, tgt, tau=0.0, message="default")
    assert float(np.abs(direct).max()) > 50 * WIRE_TOL
    answers = []

    def one_request():
        port = int(re.search(r"serving on http://127\.0\.0\.1:(\d+)", capsys.readouterr().out).group(1))
        body = json.dumps({"audio_path": wav, "src_se": src.tolist(), "tgt_se": tgt.tolist(), "tau": 0.0}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/convert", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answers.append(np.frombuffer(base64.b64decode(json.loads(r.read())["audio_b64"]), np.float32))
        raise KeyboardInterrupt

    monkeypatch.setattr(tools, "_serve_until_interrupted", one_request)
    assert tools.main(["serve", *_args(root, "--ckpt", str(root / "converted"), "--port", "0")]) == 0
    np.testing.assert_allclose(answers[0], direct, atol=WIRE_TOL)


def test_extract_se_equals_the_api(files, tmp_path):
    root, wav = files
    out = str(tmp_path / "se.npy")
    assert tools.main(["extract-se", wav, *_args(root, "--ckpt", str(root / "ckpt.pth"), "--out", out,
                                                 "--no-vad")]) == 0
    tc = ToneColorConverter(config_path=str(root / "config.json"), device="cpu")
    tc.load_ckpt(str(root / "ckpt.pth"))
    se = np.load(out)
    assert se.shape == (1, TINY_API["gin_channels"], 1)
    np.testing.assert_array_equal(se, tc.extract_se_from_file(wav, vad=False))


def test_train_writes_checkpoints(files, tmp_path):
    root, _ = files
    data = tmp_path / "data"
    for spk, f0 in (("a", 220), ("b", 330)):
        (data / spk).mkdir(parents=True)
        t = np.arange(22050) / 22050
        write_wav(str(data / spk / "clip.wav"), (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), 22050)
    ckpt = str(tmp_path / "ckpt")
    assert tools.main(["train", str(data), *_args(root, "--steps", "2", "--batch", "2", "--segment-frames", "16",
                                                  "--no-gan", "--ckpt-dir", ckpt)]) == 0
    assert CIO.latest_step(ckpt) == 2


@pytest.mark.parametrize("cmd", ["convert-ckpt", "serve", "train", "extract-se"])
def test_each_subcommand_raises_without_cuda_unless_the_cpu_is_named(cmd, files, tmp_path, monkeypatch):
    root, wav = files
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    argv = {"convert-ckpt": ["convert-ckpt", str(root / "ckpt.pth"), str(tmp_path / "out")],
            "serve": ["serve", "--port", "0"], "train": ["train", str(tmp_path)],
            "extract-se": ["extract-se", wav]}[cmd]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tools.main([*argv, "--config", str(root / "config.json")])
