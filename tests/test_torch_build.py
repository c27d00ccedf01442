"""The kernel build's cache key (``repro_torch.kernels.build._target``).

A library is keyed by a hash of its ``.cu`` source, every ``csrc/*.cuh``
header and the flags, so that an edit to a shared header such as
``mma_tiles.cuh`` rebuilds the sources that include it instead of loading
a stale library.  These tests run on the CPU against a copy of ``csrc/``
and never start ``nvcc``.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources, with the build pointed at it and at
    an empty build root; any attempt to run nvcc fails the test."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")

    def no_nvcc(*args, **kwargs):
        raise AssertionError(f"nvcc was started: {args}")
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(subprocess, "Popen", no_nvcc)
    return copy


def _targets():
    return {name: build._target(name) for name in build.SOURCES}


def test_target_is_stable_and_under_the_build_root(csrc):
    first = _targets()
    assert first == _targets()
    for name, path in first.items():
        assert path.parent.parent == build.BUILD_ROOT
        assert path.name == f"lib{name}.so"
        assert path.parent.name.startswith(f"{name}-")
    assert not build.BUILD_ROOT.exists()        # _target creates nothing


@pytest.mark.parametrize("name,header", [
    ("flash_attention", "mma_tiles.cuh"),
    ("flash_attention_bwd", "mma_tiles.cuh"),
    ("paged_attention", "mma_tiles.cuh"),
    ("chunk_attention", "mma_tiles.cuh"),
    ("ssd_scan", "mma_tiles.cuh"),
    ("paged_attention", "chunk_tiles.cuh"),
    ("chunk_attention", "chunk_tiles.cuh"),
    ("grouped_matmul", "wgmma_tiles.cuh"),
])
def test_flash_kernels_include_the_shared_header(csrc, name, header):
    """The kernels on mma.sync include the shared tile header; both chunk
    kernels (paged and dense) include the chunk body's header; the grouped
    GEMM includes the wgmma/TMA header.  Both of those headers include the
    tile header."""
    assert f'#include "{header}"' in (csrc / f"{name}.cu").read_text()
    for shared in ("wgmma_tiles.cuh", "chunk_tiles.cuh"):
        assert '#include "mma_tiles.cuh"' in (csrc / shared).read_text()


@pytest.mark.parametrize("name", build.SOURCES)
def test_header_edit_changes_the_target(csrc, name):
    before = build._target(name)
    header = csrc / "mma_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._target(name) != before


@pytest.mark.parametrize("name", build.SOURCES)
def test_source_edit_changes_only_its_own_target(csrc, name):
    before = _targets()
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _targets()
    assert after[name] != before[name]
    assert {n: p for n, p in after.items() if n != name} == \
        {n: p for n, p in before.items() if n != name}


def test_wgmma_header_edit_changes_every_target(csrc):
    """The wgmma/TMA header, like every csrc/*.cuh, keys every library."""
    before = _targets()
    header = csrc / "wgmma_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _targets()
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_new_header_changes_the_targets(csrc):
    before = _targets()
    (csrc / "extra_tiles.cuh").write_text("#pragma once\n")
    after = _targets()
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_flags_change_the_target(csrc, monkeypatch):
    before = _targets()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = _targets()
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_no_nvcc_on_import_or_in_target(tmp_path):
    """Importing the kernel modules and computing every target starts no
    process (a fresh interpreter, with process creation made to fail)."""
    code = (
        "import subprocess, sys\n"
        "def boom(*a, **k):\n"
        "    raise SystemExit('a process was started: %r' % (a,))\n"
        "subprocess.Popen = subprocess.run = boom\n"
        "from pathlib import Path\n"
        "from repro_torch.kernels import build, ops\n"
        f"build.BUILD_ROOT = Path({str(tmp_path / 'build')!r})\n"
        "targets = [build._target(n) for n in build.SOURCES]\n"
        "assert not build.BUILD_ROOT.exists()\n"
        "assert build._libs == {} and build.build_log == {}\n"
        "print(len(targets))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(len(build.SOURCES))
