"""The PyTorch port's package rules: it imports neither JAX nor the JAX
package, it never hides the device (no silent CPU path), its kernel wrappers
raise on what their kernels do not take instead of falling back, and a
kernel's library is rebuilt when a header it shares changes."""

import ast
import contextlib
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from openvoice_tpu_torch.api import BaseSpeakerTTS, ToneColorConverter
from openvoice_tpu_torch.models import synthesizer as S
from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
from openvoice_tpu_torch.nn.flows import ResidualCouplingBlock
from openvoice_tpu_torch.nn.hifigan import ResBlock1
from openvoice_tpu_torch.nn.wavenet import WN
from openvoice_tpu_torch.ops import _nvcc, coupling_cuda, mrf_cuda, stft_cuda, tail_cuda, wn_cuda
from tests._torch_port import TINY, TINY_TTS_TAIL, torch_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "openvoice_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "openvoice_tpu"), f"{path.name} imports {name}"


def test_inference_and_checkpoints_load_no_training_module():
    """The layers stack one way: the API and the checkpoint layer load
    without the training layer, which builds on them."""
    code = ("import sys, openvoice_tpu_torch.api, openvoice_tpu_torch.ckpt.from_jax, "
            "openvoice_tpu_torch.ckpt.native_io; "
            "print([m for m in sys.modules if m.startswith('openvoice_tpu_torch.training')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_converter_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToneColorConverter(cfg=torch_cfg(TINY))


def test_base_speaker_tts_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL))
    tts = BaseSpeakerTTS(cfg=torch_cfg(TINY_TTS_TAIL), device="cpu")
    assert tts.device.type == "cpu" and tts.version == "v1"


@pytest.mark.parametrize("make", ["ConvertBatcher", "VoiceService", "VoiceApp"])
def test_serving_tier_without_device_raises_when_cuda_is_absent(make, monkeypatch):
    """The serving tier's entry points run on the card unless asked for the
    CPU, like the converter's."""
    from openvoice_tpu_torch.serve.app import VoiceApp
    from openvoice_tpu_torch.serve.batcher import ConvertBatcher
    from openvoice_tpu_torch.serve.server import VoiceService

    cfg = torch_cfg(TINY)
    tc = ToneColorConverter(cfg=cfg, device="cpu")
    tc.init_random(0)
    build = {"ConvertBatcher": lambda **kw: ConvertBatcher(tc.model, cfg, **kw),
             "VoiceService": lambda **kw: VoiceService(tc, **kw),
             "VoiceApp": lambda **kw: VoiceApp(tc, **kw)}[make]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    made = build(device="cpu")
    assert made.device.type == "cpu"
    if make == "VoiceService":
        made.close()


@pytest.mark.parametrize("entry", ["train", "init_train_state", "init_gan_train_state", "mel_cepstra"])
def test_training_entry_points_without_device_raise_when_cuda_is_absent(entry, tmp_path, monkeypatch):
    """Training and its quality metrics run on the card unless asked for the
    CPU, like the converter."""
    from openvoice_tpu_torch.audio.io import write_wav
    from openvoice_tpu_torch.training import train as T
    from openvoice_tpu_torch.training.loop import train
    from openvoice_tpu_torch.training.quality import mel_cepstra

    cfg = torch_cfg(TINY)
    (tmp_path / "spk").mkdir()
    write_wav(str(tmp_path / "spk" / "a.wav"), np.zeros(22050, np.float32), 22050)
    call = {"train": lambda **kw: train(str(tmp_path), cfg, steps=0, batch_size=1, segment_frames=16, **kw),
            "init_train_state": lambda **kw: T.init_train_state(cfg, torch.Generator().manual_seed(0), **kw),
            "init_gan_train_state": lambda **kw: T.init_gan_train_state(cfg, torch.Generator().manual_seed(0), **kw),
            "mel_cepstra": lambda **kw: mel_cepstra(np.zeros(4096, np.float32), 22050, **kw)}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    call(device="cpu")


def test_serving_mode_is_refused_until_its_kernels_exist():
    """The kernels exist now, so the serving mode runs (on the CPU through
    their plain versions); what is still refused is the graph's fast mode
    without its packed weights."""
    tc = ToneColorConverter(cfg=torch_cfg(TINY), device="cpu")
    tc.init_random(0)
    out = tc.convert(np.zeros(4000, np.float32), np.zeros(64), np.zeros(64), fast=True, message="")
    assert out.dtype == np.float32 and np.isfinite(out).all() and len(out) > 0
    with pytest.raises(ValueError, match="make_dec_cache"):
        S.voice_conversion(tc.model, torch.zeros(1, 8, 129), torch.tensor([8]), torch.zeros(1, 1, 64),
                           torch.zeros(1, 1, 64), 0.3, torch.zeros(1, 8, 64), fast=True)


def _wn_call():
    wn = WN(16, 5, 2, 0).eval()
    return wn_cuda.wn_stack, wn_cuda.stack_wn_params(wn, torch.float32), (2, 12, 16), (torch.zeros(2, 2, 32),)


def _coupling_call():
    flow = ResidualCouplingBlock(16, 16, 5, 2, 2, 0).eval()
    packed = coupling_cuda.pack_coupling_block(flow, reverse=False, dtype=torch.float32)
    return coupling_cuda.coupling_block, packed, (2, 12, 16), (torch.zeros(2, 2, 2, 32),)


def _mrf_call():
    packed = mrf_cuda.pack_stage_weights([ResBlock1(16, 3, (1, 3)).eval()], torch.float32)
    return mrf_cuda.mrf_stage, packed, (2, 12, 16), ()


def _tail_call():
    packed = tail_cuda.pack_tail_weights(conv_transpose1d(32, 16, 4, 2).eval(), [ResBlock1(16, 3, (1, 3)).eval()],
                                         conv1d(16, 1, 7, bias=False).eval(), torch.float32)
    return tail_cuda.tail_stage, packed, (2, 12, 32), ()


@pytest.mark.parametrize("make", [_wn_call, _coupling_call, _mrf_call, _tail_call],
                         ids=["wn_stack", "coupling_block", "mrf_stage", "tail_stage"])
@torch.inference_mode()
def test_kernel_wrappers_raise_instead_of_falling_back(make):
    fn, packed, shape, extra = make()
    lengths = torch.tensor([shape[1], shape[1] - 3])
    good = torch.randn(shape)
    assert torch.isfinite(fn(good, lengths, packed, *extra)).all()
    with pytest.raises(TypeError, match="must agree"):           # not the packed weights' dtype
        fn(good.to(torch.float64), lengths, packed, *extra)
    with pytest.raises(TypeError, match="must agree"):
        fn(good.to(torch.bfloat16), lengths, packed, *extra)
    strided = torch.randn(shape[0], shape[2], shape[1]).transpose(1, 2)
    assert strided.shape == good.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fn(strided, lengths, packed, *extra)
    with pytest.raises(ValueError):
        fn(good[0], lengths, packed, *extra)                      # not [B, T, C]


def test_graph_capture_raises_instead_of_falling_back(monkeypatch):
    """runtime/graphs.py: a capture or a replay that fails raises out of
    `GraphCache.run` and is never swallowed.  Nothing is kept, the next call
    of the key tries the capture again and raises again, no eager result
    comes back in its place, and the module holds no exception handler."""
    from openvoice_tpu_torch.runtime import graphs as G

    tree = ast.parse((ROOT / "openvoice_tpu_torch" / "runtime" / "graphs.py").read_text())
    assert not any(isinstance(node, ast.ExceptHandler) for node in ast.walk(tree))

    class Stream:  # stand-ins for the card's streams and events: this machine has none
        def wait_event(self, event):
            pass

        def wait_stream(self, stream):
            pass

    class Event:
        def record(self, stream=None):
            pass

    def failing_capture(*args, **kwargs):
        raise RuntimeError("capture failed: operation not permitted when stream is capturing")

    monkeypatch.setattr(G.GraphCache, "active", lambda self: True)
    monkeypatch.setattr(G, "_streams", lambda device: (Stream(), Stream()))
    monkeypatch.setattr(G, "_pool", lambda device: None)
    monkeypatch.setattr(G, "_LAST", {})
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", failing_capture)
    cache, warmups = G.GraphCache("cpu"), []

    def body(x):
        warmups.append(1)
        return x * 2

    key = G.GraphKey("convert", bucket=64, batch=1, fast=False)
    for n in (1, 2):
        with pytest.raises(RuntimeError, match="capture failed"):
            cache.run(key, body, {"x": np.ones(3, np.float32)})
        assert len(cache) == cache.captures == 0 and len(warmups) == n

    class FailingGraph:
        def replay(self):
            raise RuntimeError("replay failed")

    static = {"x": torch.zeros(3)}
    cache._graphs[key._replace(device="cpu")] = G.CapturedGraph(FailingGraph(), static, static["x"], {}, 0.0)
    with pytest.raises(RuntimeError, match="replay failed"):
        cache.run(key, body, {"x": np.ones(3, np.float32)})
    assert len(warmups) == 2 and cache.replays == 0


def test_stft_wrapper_raises_instead_of_falling_back():
    audio = torch.zeros(1, 2048)
    with pytest.raises(TypeError, match="float32"):
        stft_cuda.stft_magnitude(audio.double(), 1024, 256, 1024)
    with pytest.raises(ValueError, match="contiguous"):
        stft_cuda.stft_magnitude(torch.zeros(2048, 2).t()[:1], 1024, 256, 1024)


def test_library_path_changes_when_a_shared_header_changes(tmp_path, monkeypatch):
    """K1/K2 and K3/K4 share device code in headers: the library's name must
    follow them, or a stale build would load silently."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_nvcc.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_nvcc, "CSRC", csrc)
    monkeypatch.setattr(_nvcc, "BUILD_DIR", csrc / "build")
    names = _nvcc.kernel_names()
    assert {"stft", "wn", "coupling", "mrf", "tail"} <= set(names)
    before = {name: _nvcc.library_path(name) for name in names}
    assert before == {name: _nvcc.library_path(name) for name in names}
    assert len(set(before.values())) == len(names)
    header = csrc / "mma_tile.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {name: _nvcc.library_path(name) for name in names}
    assert all(after[name] != before[name] for name in ("wn", "coupling", "mrf", "tail"))
    # a library left in build/ does not count as a source
    (csrc / "build").mkdir()
    (csrc / "build" / "libwn-0.so").write_bytes(b"x")
    assert after == {name: _nvcc.library_path(name) for name in names}


@pytest.mark.parametrize("entry", ["global_mesh", "make_mesh", "make_hybrid_mesh", "initialize", "topology",
                                   "HeartbeatMonitor"])
def test_mesh_tier_without_devices_raises_when_cuda_is_absent(entry, monkeypatch):
    """The mesh tier takes the card unless the caller names the CPU: no
    mesh, topology or heartbeat falls back to the CPU on its own."""
    from openvoice_tpu_torch.runtime import mesh as M
    from openvoice_tpu_torch.runtime import multihost as MH

    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    call = {"global_mesh": lambda cpu: MH.global_mesh(1, **({"devices": ["cpu"]} if cpu else {})),
            "make_mesh": lambda cpu: M.make_mesh(**({"devices": ["cpu"]} if cpu else {})),
            "make_hybrid_mesh": lambda cpu: M.make_hybrid_mesh(["cpu"] if cpu else None),
            "initialize": lambda cpu: MH.initialize(**({"device": "cpu"} if cpu else {})),
            "topology": lambda cpu: MH.topology(["cpu"] if cpu else None),
            "HeartbeatMonitor": lambda cpu: MH.HeartbeatMonitor(**({"device": "cpu"} if cpu else {}))}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(False)
    call(True)


def test_a_group_another_caller_started_takes_the_card_of_its_local_rank(monkeypatch):
    """A process in a group that `initialize` did not start (torchrun, say)
    contributes ``cuda:<LOCAL_RANK mod device count>``, whatever the
    backend, and raises without CUDA."""
    from openvoice_tpu_torch.runtime import multihost as MH

    monkeypatch.setattr(MH, "_DEVICE", None)
    monkeypatch.setattr(MH.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(MH.dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MH.process_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert MH.process_device() == torch.device("cuda", 1)


@pytest.mark.parametrize("entry", ["DistributedConvertService", "worker_main", "live_worker_main", "tools.main"])
def test_elastic_tier_and_cli_without_device_raise_when_cuda_is_absent(entry, tmp_path, monkeypatch):
    """The distributed service, the elastic and live workers and the CLI take
    the card unless the caller names the CPU."""
    from openvoice_tpu_torch import tools
    from openvoice_tpu_torch.runtime.elastic import WorkLog, worker_main
    from openvoice_tpu_torch.runtime.mesh import make_mesh
    from openvoice_tpu_torch.serve.distributed import DistributedConvertService
    from openvoice_tpu_torch.serve.elastic_live import LiveWorkLog, live_worker_main

    cfg = torch_cfg(TINY)
    model = S.init_synthesizer(cfg, torch.Generator().manual_seed(0))
    log = LiveWorkLog(str(tmp_path))
    log.write_params(model)
    WorkLog(str(tmp_path)).write_requests([])
    log.signal_stop()  # the live world drains at once
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)

    def call(cpu: bool):
        dev = {"device": "cpu"} if cpu else {}
        if entry == "DistributedConvertService":
            return DistributedConvertService(model, cfg, make_mesh(1, devices=["cpu"]), **dev)
        if entry == "worker_main":
            return worker_main(str(tmp_path), cfg, coordinator=None, num_processes=1, process_id=0, **dev)
        if entry == "live_worker_main":
            return live_worker_main(str(tmp_path), cfg, coordinator=None, num_processes=1, process_id=0, **dev)
        out = str(tmp_path / "se.npy")
        wav = str(tmp_path / "a.wav")
        from openvoice_tpu_torch.audio.io import write_wav

        write_wav(wav, np.zeros(4096, np.float32), 22050)
        return tools.main(["extract-se", wav, "--no-vad", "--out", out, *(["--device", "cpu"] if cpu else [])])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(False)
    call(True)


# -- the installable port ------------------------------------------------------

PACKAGE = ROOT / "openvoice_tpu_torch"
CODEC_SOURCES = sorted(p.name for p in (ROOT / "native" / "src").iterdir())


def _package_copy(dest: pathlib.Path) -> pathlib.Path:
    """``openvoice_tpu_torch/`` copied to `dest`, without what builds and
    imports leave in it."""
    shutil.copytree(PACKAGE, dest / "openvoice_tpu_torch", ignore=shutil.ignore_patterns("build", "__pycache__"))
    return dest


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The names in a wheel built from a copy of the tree (pip, no network),
    and its entry_points.txt."""
    pytest.importorskip("setuptools")
    import zipfile

    src = tmp_path_factory.mktemp("tree")
    for name in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy(ROOT / name, src / name)
    shutil.copytree(ROOT / "openvoice_tpu", src / "openvoice_tpu", ignore=shutil.ignore_patterns("__pycache__"))
    _package_copy(src)
    dist = src / "dist"
    subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps", "--no-build-isolation", "--no-index",
                    "--disable-pip-version-check", "--no-cache-dir",
                    "-q", "-w", str(dist)], cwd=src, check=True, capture_output=True, text=True, timeout=300)
    (path,) = dist.glob("*.whl")
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        entry_points = z.read(next(n for n in names if n.endswith(".dist-info/entry_points.txt"))).decode()
    return names, entry_points


def test_the_wheel_holds_the_sources_the_port_builds_and_its_demos(wheel):
    names, entry_points = wheel
    data = [p for p in PACKAGE.rglob("*") if p.is_file() and p.suffix not in (".py", ".pyc")
            and not {"build", "__pycache__"} & set(p.relative_to(PACKAGE).parts)]
    assert {p.suffix for p in data} == {".cu", ".cuh", ".cc", ".h"}
    demos = sorted((PACKAGE / "demos").glob("*.py"))
    assert len(demos) == 6
    for path in data + demos:
        assert str(path.relative_to(ROOT)) in names, path
    assert not [n for n in names if "/csrc/build/" in n]
    assert "openvoice-tpu-torch = openvoice_tpu_torch.tools:main" in entry_points.splitlines()


def test_every_source_the_port_builds_lies_in_its_package():
    from openvoice_tpu_torch.audio import _native_build

    for path in (_nvcc.CSRC, _nvcc.BUILD_DIR, _native_build.SRC, _native_build.BUILD_DIR):
        assert PACKAGE in path.parents, path


@pytest.mark.parametrize("name", CODEC_SOURCES)
def test_codec_sources_are_a_byte_equal_copy(name):
    """The port builds its codecs from its own copy of ``native/src``."""
    from openvoice_tpu_torch.audio import _native_build

    assert sorted(p.name for p in _native_build.SRC.iterdir()) == CODEC_SOURCES
    assert (_native_build.SRC / name).read_bytes() == (ROOT / "native" / "src" / name).read_bytes()


def test_a_copy_of_the_package_alone_runs_the_cli(tmp_path):
    """The package copied alone (PYTHONPATH that directory only, the working
    directory elsewhere): the CLI's help, then extract-se of a FLAC clip,
    which builds the codec library from the copy's own sources into the
    copy's ``csrc/build``."""
    from openvoice_tpu_torch.audio.io import write_wav
    from tests._torch_port import TINY_API, write_reference_checkpoint

    site = _package_copy(tmp_path / "site")
    work = tmp_path / "work"
    work.mkdir()
    config, ckpt = write_reference_checkpoint(work, TINY_API, seed=4)
    clip = np.random.default_rng(0).standard_normal(11025).astype(np.float32) * 0.1
    wav, flac = work / "clip.wav", work / "clip.flac"
    write_wav(str(wav), clip, 22050)
    env = {**os.environ, "PYTHONPATH": str(site)}

    def port(*args: str) -> str:
        return subprocess.run([sys.executable, *args], cwd=work, env=env, check=True, capture_output=True,
                              text=True, timeout=300).stdout

    assert "extract-se" in port("-m", "openvoice_tpu_torch.tools", "--help")
    found = port("-c", "import sys, openvoice_tpu_torch.tools as t; print(t.__file__); "
                 "print([m for m in sys.modules if m.split('.')[0] in ('openvoice_tpu', 'jax')])")
    assert found.splitlines() == [str(site / "openvoice_tpu_torch" / "tools.py"), "[]"]
    port("-c", "from openvoice_tpu_torch.audio.io import load_audio; from openvoice_tpu_torch.audio.flac import "
               f"write_flac; write_flac({str(flac)!r}, load_audio({str(wav)!r})[0], 22050)")
    assert [p.name.split("-")[0] for p in (site / "openvoice_tpu_torch" / "csrc" / "build").glob("*.so")] \
        == ["libovt_audio"]
    out = port("-m", "openvoice_tpu_torch.tools", "extract-se", str(flac), "--config", config, "--ckpt", ckpt,
               "--device", "cpu", "--no-vad", "--out", str(work / "se.npy"))
    assert "SE (1, 64, 1)" in out
    tc = ToneColorConverter(config_path=config, device="cpu")
    tc.load_ckpt(ckpt)
    np.testing.assert_array_equal(np.load(work / "se.npy"), tc.extract_se_from_file(str(wav), vad=False))
