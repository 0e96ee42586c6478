"""Build and load the in-repo audio codec libraries for the port.

The C++ sources under ``native/src`` (WAV, mp3 through a dlopen'd
mpg123/lame, Ogg/Vorbis through a dlopen'd libvorbis*, a from-scratch FLAC,
the resampler, the VAD and the threaded prefetch loader) are compiled with
the host ``c++`` into ``openvoice_tpu_torch/csrc/build/`` (git-ignored), with
the source list and flags of ``native/CMakeLists.txt``:

* ``libovt_audio`` from wav, resample, vad, mp3, vorbis, flac and loader,
  ``-O3 -march=native -fno-math-errno -std=c++17 -fPIC``, pthread, ``-ldl``;
  a failed build raises;
* ``libovt_ffdec`` (m4a/aac/mp4/… through the system ffmpeg) only where the
  avformat, avcodec, avutil and swresample headers and libraries are found.

A library's name holds a digest of its flags, its sources, the compiler's
version and the host CPU's flags (``-march=native`` code must not run on
another CPU), so an unchanged tree loads at once and a stale library is never
loaded.  Each build writes a temporary file that ``os.replace`` moves into
place, and a file lock keeps concurrent processes from building the same
library twice.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
SRC = ROOT / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-std=c++17", "-fPIC", "-shared")
FFMPEG_LIBS = ("avformat", "avcodec", "avutil", "swresample")
FFMPEG_HEADERS = ("libavformat/avformat.h", "libavcodec/avcodec.h", "libavutil/opt.h",
                  "libswresample/swresample.h")
LIBRARIES = {
    "ovt_audio": (("wav.cc", "resample.cc", "vad.cc", "mp3.cc", "vorbis.cc", "flac.cc", "loader.cc"),
                  ("-pthread", "-ldl")),
    "ovt_ffdec": (("ffdec.cc",), tuple(f"-l{name}" for name in FFMPEG_LIBS)),
}

_LIBS: dict[str, ctypes.CDLL | None] = {}
_LOCK = threading.Lock()


def _cxx() -> str:
    return os.environ.get("CXX", "c++")


def _host_tag() -> bytes:
    """The compiler's version and the CPU's feature flags."""
    version = subprocess.run([_cxx(), "--version"], capture_output=True, text=True).stdout
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        pass
    return (version + "\0" + flags).encode()


def library_path(name: str) -> Path:
    sources, libs = LIBRARIES[name]
    digest = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode() + b"\0" + _host_tag())
    for src in sorted((*sources, "ovt_audio.h")):
        digest.update(src.encode() + b"\0" + (SRC / src).read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ffmpeg_found() -> bool:
    """The four ffmpeg libraries resolve and their headers compile."""
    if not all(ctypes.util.find_library(name) for name in FFMPEG_LIBS):
        return False
    probe = "".join(f"#include <{h}>\n" for h in FFMPEG_HEADERS)
    proc = subprocess.run([_cxx(), "-std=c++17", "-fsyntax-only", "-x", "c++", "-"], input=probe,
                          capture_output=True, text=True)
    return proc.returncode == 0


def build(name: str) -> Path:
    """Compile library `name` unless it exists; returns its path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources, libs = LIBRARIES[name]
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time; the other processes then load its result
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [_cxx(), *CXX_FLAGS, f"-I{SRC}", *(str(SRC / s) for s in sources), "-o", str(tmp), *libs],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"c++ failed on lib{name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL | None:
    """The loaded library, built first if needed.  ``ovt_ffdec`` is None
    where ffmpeg's headers or libraries are absent; any other failed build
    raises."""
    with _LOCK:
        if name not in _LIBS:
            if name == "ovt_ffdec" and not ffmpeg_found():
                _LIBS[name] = None
            else:
                _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]
