"""The port's demos (``openvoice_tpu_torch/demos``) against the JAX package's
(``demos/demo_*.py``) on the CPU.  Each JAX demo runs unmodified through
`runpy` with a patched ``sys.argv``, the port's through ``main([...,
"--device", "cpu"])``, each in a working directory of its own (``get_se``
caches under ``./processed``), on the same reference-format checkpoints and
the same seeded synthetic WAVs; their output WAVs are compared: the f32
paths within the port's audio bar, the serving-mode fused chains within the
bar the port's chains keep against their f32 audio.  The watermark demo's
table of recovered messages must be the JAX demo's, row for row."""

import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest

from openvoice_tpu import api as japi
from openvoice_tpu import config as jconfig
from openvoice_tpu_torch import api as tapi
from openvoice_tpu_torch import config as tconfig
from openvoice_tpu_torch.audio.io import load_audio, write_wav
from openvoice_tpu_torch.demos import external_tts, fused_chain, v1_tts, v2_conversion, watermark_robustness
from openvoice_tpu_torch.text import default_symbols
from tests._torch_port import (
    AUDIO_TOL, TINY_API, TINY_TAIL, TINY_TTS_TAIL, TINY_V1, jax_cfg, torch_cfg, write_reference_checkpoint,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SR = 22050
SERVING_BAR = 0.05  # of the peak: serving mode against f32 (tests/test_torch_fused.py::test_serving_mode_chains)
TEXT = ("The weather is nice today and we should go for a walk. "
        "Later we can have dinner together with our friends.")
TTS_EXTRA = {"symbols": list(default_symbols), "speakers": {"default": 0, "whispering": 1},
             "data": {"text_cleaners": ["cjke_cleaners2"], "add_blank": True}}


def voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A voiced, speech-like clip: harmonics under a syllable envelope."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * tt))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 2.5 * tt), 0, None) ** 0.5
    return (0.3 * x * env + 0.005 * rng.standard_normal(len(tt))).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format checkpoints (V2 and V1 converters, the TTS, the fused
    chain's converter) and the source and reference WAVs."""
    root = tmp_path_factory.mktemp("demos")
    out = {}
    for name, fields, seed, extra in (("v2", TINY_API, 4, {}), ("v1", TINY_V1, 5, {}),
                                      ("tts", TINY_TTS_TAIL, 6, TTS_EXTRA), ("tail", TINY_TAIL, 7, {})):
        (root / name).mkdir()
        out[name] = write_reference_checkpoint(root / name, fields, seed, random_post=True, **extra)
    out["source"], out["reference"] = str(root / "source.wav"), str(root / "reference.wav")
    write_wav(out["source"], voice(2.0, 130.0, seed=1), SR)
    write_wav(out["reference"], voice(1.5, 210.0, seed=2), SR)
    return out


def run_jax_demo(name: str, argv: list[str], cwd: pathlib.Path, monkeypatch) -> None:
    """``python demos/demo_<name>.py <argv>`` in `cwd`, in this process."""
    script = str(ROOT / "demos" / f"demo_{name}.py")
    cwd.mkdir()
    with monkeypatch.context() as m:
        m.chdir(cwd)
        m.setattr(sys, "argv", [script, *argv])
        m.setattr(sys, "path", list(sys.path))  # the demo inserts the repository root
        runpy.run_path(script, run_name="__main__")


def run_port_demo(main, argv: list[str], cwd: pathlib.Path, monkeypatch) -> None:
    cwd.mkdir()
    with monkeypatch.context() as m:
        m.chdir(cwd)
        assert main([*argv, "--device", "cpu"]) == 0


def wav(path: pathlib.Path) -> np.ndarray:
    return load_audio(str(path), sr=None)[0]


def close(out: np.ndarray, ref: np.ndarray, bar: float) -> None:
    assert out.shape == ref.shape
    peak = float(np.abs(ref).max())
    assert peak > 20 * AUDIO_TOL  # loud enough for the bar to mean something (conv_post ×100)
    assert float(np.abs(out - ref).max()) <= bar, (float(np.abs(out - ref).max()), peak)


def test_v2_conversion_matches_the_jax_demo(files, tmp_path, monkeypatch):
    config, ckpt = files["v2"]
    argv = ["--ckpt", ckpt, "--config", config, "--source", files["source"], "--reference", files["reference"]]
    run_jax_demo("v2_conversion", argv, tmp_path / "jax", monkeypatch)
    run_port_demo(v2_conversion.main, argv, tmp_path / "port", monkeypatch)
    for side in ("jax", "port"):  # both SEs went through get_se's cache
        assert len(list((tmp_path / side / "processed").glob("*/se.npy"))) == 2
    close(wav(tmp_path / "port" / "outputs" / "converted.wav"), wav(tmp_path / "jax" / "outputs" / "converted.wav"),
          AUDIO_TOL)


def test_v1_tts_matches_the_jax_demo(files, tmp_path, monkeypatch):
    """--parity: the TTS decode in f32, then get_se and convert (f32)."""
    (tts_config, tts_ckpt), (conv_config, conv_ckpt) = files["tts"], files["v1"]
    argv = ["--tts-ckpt", tts_ckpt, "--tts-config", tts_config, "--converter-ckpt", conv_ckpt,
            "--converter-config", conv_config, "--reference", files["reference"], "--parity",
            "--text", TEXT, "--speed", "0.15"]  # the tiny TTS's random durations make 0.3 s at speed 1
    run_jax_demo("v1_tts", argv, tmp_path / "jax", monkeypatch)
    run_port_demo(v1_tts.main, argv, tmp_path / "port", monkeypatch)
    for name in ("tmp_tts.wav", "demo_v1.wav"):
        close(wav(tmp_path / "port" / "outputs" / name), wav(tmp_path / "jax" / "outputs" / name), AUDIO_TOL)


def test_external_tts_matches_the_jax_demo(files, tmp_path, monkeypatch):
    config, ckpt = files["v1"]
    argv = ["--ckpt", ckpt, "--config", config, "--sources", files["source"], files["reference"],
            "--reference", files["reference"]]
    run_jax_demo("external_tts", argv, tmp_path / "jax", monkeypatch)
    run_port_demo(external_tts.main, argv, tmp_path / "port", monkeypatch)
    for name in ("source_converted.wav", "reference_converted.wav"):
        close(wav(tmp_path / "port" / "outputs" / name), wav(tmp_path / "jax" / "outputs" / name), AUDIO_TOL)


def test_fused_chain_matches_the_jax_demo(files, tmp_path, monkeypatch):
    """The serving-mode chains, both demos on the same tiny TTS (their random
    TTS and its preset patched to TINY_TTS_TAIL's checkpoint in each package:
    the JAX demo's ``--tts-config`` path passes speaker id 0, which a TTS with
    a speakers map refuses) and the same TINY_TAIL converter checkpoint."""
    tts_config, tts_ckpt = files["tts"]
    config, ckpt = files["tail"]
    monkeypatch.setattr(jconfig, "v1_base_tts_config", lambda n_vocab, n_speakers=10: jax_cfg(TINY_TTS_TAIL))
    monkeypatch.setattr(tconfig, "v1_base_tts_config", lambda n_vocab, n_speakers=10: torch_cfg(TINY_TTS_TAIL))
    for api in (japi, tapi):
        monkeypatch.setattr(api.BaseSpeakerTTS, "init_random", lambda self, seed=0: self.load_ckpt(tts_ckpt))
    argv = ["--converter-ckpt", ckpt, "--converter-config", config]
    run_jax_demo("fused_chain", argv, tmp_path / "jax", monkeypatch)
    run_port_demo(fused_chain.main, argv, tmp_path / "port", monkeypatch)
    for name in ("demo_chain_single.wav", "demo_chain_stream.wav"):
        ref = wav(tmp_path / "jax" / "outputs" / name)
        close(wav(tmp_path / "port" / "outputs" / name), ref, SERVING_BAR * float(np.abs(ref).max()))

    # with the TTS's own config the port's demo speaks in its first speaker
    run_port_demo(fused_chain.main, [*argv, "--tts-ckpt", tts_ckpt, "--tts-config", tts_config,
                                     "--output-dir", "cfg"], tmp_path / "port_cfg", monkeypatch)
    for name in ("demo_chain_single.wav", "demo_chain_stream.wav"):
        np.testing.assert_array_equal(wav(tmp_path / "port_cfg" / "cfg" / name),
                                      wav(tmp_path / "port" / "outputs" / name))


def _table(text: str) -> list[tuple[str, str]]:
    """(abuse, decoded message or "(skipped)") for each row of the demo's table."""
    rows = [(line[:42].rstrip(), line[42:].strip()) for line in text.splitlines() if len(line) > 42]
    return [row for row in rows if row[1].startswith(("OK ", "FAIL ", "(skipped)"))]


def test_watermark_robustness_matches_the_jax_demo(tmp_path, capsys):
    """The same 4 s host through every abuse this machine's codecs allow:
    the JAX demo (in a process of its own, meanwhile) and the port's must
    recover the same message from each, and skip the same codecs."""
    host = str(tmp_path / "host.wav")
    write_wav(host, watermark_robustness.speechlike(4 * SR, seed=3), SR)
    jax_run = subprocess.Popen([sys.executable, str(ROOT / "demos" / "demo_watermark_robustness.py"), "--audio",
                                host], cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        assert watermark_robustness.main(["--audio", host, "--device", "cpu"]) == 0
        jax_out, _ = jax_run.communicate(timeout=300)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0
    ours, theirs = _table(capsys.readouterr().out), _table(jax_out)
    assert ours == theirs
    assert len(ours) == 17 and ("untouched", "OK  '@MyShell'") in ours
