"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
for `sm_90a` at first use into `build/kernels/` at the repository root (one
shared library per source, named by a hash of the source and its flags, so
an edited source is rebuilt), then loaded with ctypes.  `build()` starts one
`nvcc` per source that is not built yet, all at once, and waits for them.

`LAUNCHES` counts the launches of every kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source flags: the QSGD kernels must round every float operation on its
# own (codes and payloads are held bit for bit), so no FMA contraction there
SOURCES = {"qsgd": ("-fmad=false",), "flash_attention": ()}

LAUNCHES = {"qsgd_quantize_pack": 0, "qsgd_unpack_dequantize": 0,
            "qsgd_quantize": 0, "qsgd_dequantize": 0, "flash_attention": 0}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _target(name: str) -> tuple[Path, list[str]]:
    source = CSRC / f"{name}.cu"
    flags = [*COMMON_FLAGS, *SOURCES[name]]
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so", flags


def build(names=None) -> dict[str, tuple[Path, str]]:
    """Compile every named source (default: all) whose library does not
    exist yet, one `nvcc` each, in parallel.  Returns {name: (library path,
    compiler log)}; the log of an earlier build is kept beside its library.
    Raises if one fails."""
    names = list(SOURCES) if names is None else list(names)
    out, running = {}, []
    for name in names:
        lib, flags = _target(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = (lib, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    if name not in _libs:
        path, _ = build([name])[name]
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
