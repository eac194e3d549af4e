"""The window kernel's shared-memory layouts (csrc/window_layout.h), which
the kernel's build includes and the planner reads through a host build of
the same header (csrc/window_layout.cpp, ``ops/window.window_layout_bytes``).
On the CPU: the build's name follows the header, and ``ops/window``
imports and fails to plan, naming the compiler, where there is no g++; on
a card (``-m cuda``) the host build against the card build. This file
imports no JAX, so its ``cuda`` test runs on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_window_layout.py``."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.ops import window

#: The modes of ``LAYOUT_BYTES``' entries, in order.
LAYOUT_MODES = ("resident", "step", "step1", "wide", "nodes", "grid")
#: Bytes per CTA of each layout of LAYOUT_MODES at ((T, B, n, E, K), S,
#: wc), pinned from the planner's Python copy of the layouts that the
#: header replaced (and that a regex test held to the kernel's source):
#: the chunked layout's chunks, the node-resident layout's tiles and the
#: grid layout's slices are wc columns; the others take no wc.
LAYOUT_BYTES = {
    ((12, 33, 32, 32, 4096), 16, 128): (677708, 225536, 123484, 168140,
                                        104892, 138976),
    ((12, 33, 32, 32, 4096), 16, 64): (677708, 225536, 123484, 109772,
                                       92220, 95712),
    ((12, 33, 32, 32, 4096), 3, 64): (3481880, 970284, 432328, 120600,
                                      256680, 88748),
    ((12, 33, 32, 32, 4096), 1, 128): (10377488, 2825284, 1217952, 221840,
                                       694144, 131236),
    ((3, 6, 7, 5, 12), 16, 128): (4624, 8068, 7132, 40828, 14124, 26372),
    ((3, 6, 7, 5, 12), 16, 64): (4624, 8068, 7132, 22908, 10540, 16644),
    ((3, 6, 7, 5, 12), 3, 64): (3512, 6956, 6020, 21796, 9428, 15532),
    ((3, 6, 7, 5, 12), 1, 128): (6456, 7980, 6436, 39716, 13140, 25132),
    ((6, 33, 32, 32, 8192), 16, 128): (913828, 393048, 190644, 166692,
                                       137236, 133432),
    ((6, 33, 32, 32, 8192), 16, 64): (913828, 393048, 190644, 108324,
                                      124564, 90168),
    ((6, 33, 32, 32, 8192), 3, 64): (4762864, 1890148, 815936, 136880,
                                     464448, 83204),
    ((6, 33, 32, 32, 8192), 1, 128): (14238568, 5621404, 2408440, 281832,
                                      1327576, 129404),
    ((12, 33, 32, 32, 2050), 16, 128): (360304, 144304, 89292, 166156,
                                        86076, 138976),
    ((12, 33, 32, 32, 2050), 16, 64): (360304, 144304, 89292, 107788,
                                       73404, 95712),
    ((12, 33, 32, 32, 2050), 3, 64): (1754808, 510508, 239112, 109656,
                                      150504, 88748),
    ((12, 33, 32, 32, 2050), 1, 128): (5208328, 1434484, 626832, 189136,
                                       375792, 131236),
    ((64, 9, 8, 8, 100), 16, 128): (38368, 23412, 22128, 63648, 29584,
                                    46900),
    ((64, 9, 8, 8, 100), 16, 64): (38368, 23412, 22128, 42144, 25744,
                                   34356),
    ((64, 9, 8, 8, 100), 3, 64): (112204, 28064, 23452, 41068, 25756,
                                  32832),
    ((64, 9, 8, 8, 100), 1, 128): (283012, 40408, 29140, 63396, 32692,
                                   45176),
    ((12, 33, 32, 32, 16384), 16, 128): (2619212, 744704, 341596, 180428,
                                         222652, 138976),
    ((12, 33, 32, 32, 16384), 16, 64): (2619212, 744704, 341596, 122060,
                                        209980, 95712),
    ((12, 33, 32, 32, 16384), 3, 64): (13836568, 3761772, 1618184, 186136,
                                       895656, 100620),
    ((12, 33, 32, 32, 16384), 1, 128): (41441552, 11230276, 4806048,
                                        418448, 2611072, 159780),
}

_ROOT = Path(__file__).resolve().parent.parent


def test_build_name_follows_the_included_header(tmp_path, monkeypatch):
    """kernels.library_path hashes the headers a source includes: an edit
    of window_layout.h renames the builds of the kernel and of the host
    library (so neither loads a stale build), an edit of the kernel's
    source renames its build alone."""
    names = ("window_kernel", "window_layout.cpp")
    real = {name: kernels.library_path(name) for name in names}
    for f in ("window_kernel.cu", "window_layout.cpp", "window_layout.h"):
        shutil.copy(kernels._CSRC / f, tmp_path / f)
    monkeypatch.setattr(kernels, "_CSRC", tmp_path)
    assert {name: kernels.library_path(name) for name in names} == real
    with open(tmp_path / "window_layout.h", "a") as f:
        f.write("// edited\n")
    edited = {name: kernels.library_path(name) for name in names}
    assert all(edited[name] != real[name] for name in names)
    with open(tmp_path / "window_kernel.cu", "a") as f:
        f.write("// edited\n")
    assert kernels.library_path("window_kernel") != edited["window_kernel"]
    assert kernels.library_path("window_layout.cpp") == \
        edited["window_layout.cpp"]


def test_window_imports_and_names_the_missing_compiler(tmp_path):
    """With no compiler on PATH and nothing built, ops/window imports (no
    build at import) and its first plan raises naming g++."""
    script = (
        "from pathlib import Path\n"
        "from mcmc_ammsb_tpu_torch import kernels\n"
        "from mcmc_ammsb_tpu_torch.ops import window\n"
        f"kernels.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "try:\n"
        "    window.window_plan(12, 33, 32, 32, 256)\n"
        "except RuntimeError as err:\n"
        "    print(err)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=_ROOT,
                          env=dict(os.environ, PATH=str(tmp_path)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("g++ not found"), proc.stdout
    assert list(tmp_path.iterdir()) == []


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s,wc", list(LAYOUT_BYTES))
def test_host_build_is_the_card_build(cuda_device, shape, s, wc):
    """The host build's bytes (window_layout_bytes) are the card build's
    window_kernel_smem_bytes for all six layouts at every point of
    LAYOUT_BYTES, and the pinned values."""
    lib = window._window_lib()
    got = tuple(window.window_layout_bytes(shape, (s, mode, wc))
                for mode in LAYOUT_MODES)
    card = tuple(lib.window_kernel_smem_bytes(*shape, s, wc,
                                              window.LAYOUTS[mode])
                 for mode in LAYOUT_MODES)
    assert got == card == LAYOUT_BYTES[shape, s, wc]
