"""`kernels/build.py`, which compiles the port's kernels, run with a stand-in nvcc."""
import pytest

from repro_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
while [ "$1" != "-o" ]; do shift; done
echo "ptxas info    : Used 10 registers"
: > "$2"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setitem(build.SOURCES, "k", ())
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return csrc


def test_build_keeps_the_compiler_log_beside_the_library(fake_tree):
    lib, log = build.build(["k"])["k"]
    assert lib.exists() and "Used 10 registers" in log
    # built already: the same library and the log of its build
    assert build.build(["k"])["k"] == (lib, log)
    # an edited source is built anew, under another name
    (fake_tree / "k.cu").write_text("// another kernel\n")
    assert build.build(["k"])["k"][0] != lib
