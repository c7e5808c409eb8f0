"""``tools/kernel_probe.py``'s walk-less copy of ``csrc/sw.cu``: it finds
the source's one walk loop and makes it run no step, and refuses a source
with no known walk loop (so an edit of that loop stops the probe, not its
numbers)."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _probe():
    spec = importlib.util.spec_from_file_location(
        "kernel_probe", ROOT / "tools" / "kernel_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_walkless_patches_the_one_walk_loop():
    src = (ROOT / "proovread_tpu_torch" / "csrc" / "sw.cu").read_text()
    out = _probe().walkless(src)
    assert out.count("while (false)") == src.count("while (false)") + 1
    assert out.count("while (true)") == src.count("while (true)") - 1
    assert len(out) == len(src) + 1


def test_walkless_refuses_a_source_without_a_known_walk_loop():
    with pytest.raises(SystemExit, match="no single known walk loop"):
        _probe().walkless("__global__ void k() { while (true) {} }")
