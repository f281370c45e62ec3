"""The C entry points of the port's CUDA kernels against the ctypes
signatures ``csrc.KERNELS`` declares for them.

The sources compile only on the machine with the card, and a wrong
``argtypes`` list shows there only as a wrong result or a fault. This test
reads each ``csrc/*.cu``'s ``extern "C"`` entry point as text and checks
its parameters one by one: a pointer (``void*``, the stream too) is
``c_void_p``, an ``int`` is ``c_int``, a ``float`` is ``c_float``."""

import ctypes
import os
import re

import pytest

from magiattention_tpu_torch import csrc

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}


def _param_kind(decl: str) -> str:
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    words = decl.replace("const ", "").split()
    return {"int": "int", "float": "float"}.get(words[0], f"unknown: {decl}")


def _entry_params(source: str, entry: str) -> list[str]:
    with open(os.path.join(csrc._DIR, source)) as f:
        text = f.read()
    extern = text[text.index('extern "C"'):]
    m = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)\s*\{{", extern)
    assert m, f"{source} has no extern \"C\" definition of {entry}"
    return [_param_kind(p) for p in m.group(1).split(",")]


def test_every_source_is_a_kernel():
    sources = sorted(f for f in os.listdir(csrc._DIR) if f.endswith(".cu"))
    assert sources == sorted(k.source for k in csrc.KERNELS.values())


@pytest.mark.parametrize("name", sorted(csrc.KERNELS))
def test_entry_point_matches_argtypes(name):
    kernel = csrc.KERNELS[name]
    declared = [KINDS[t] for t in kernel.argtypes]
    assert _entry_params(kernel.source, kernel.entry) == declared


@pytest.mark.parametrize("name", sorted(csrc.KERNELS))
def test_headers_are_the_ones_included(name):
    """The library hash covers every header of this directory that the
    source reaches: a header edit rebuilds the kernel."""
    def includes(path):
        with open(os.path.join(csrc._DIR, path)) as f:
            found = re.findall(r'#include "([^"]+)"', f.read())
        return {h for h in found if os.path.exists(os.path.join(csrc._DIR, h))}

    kernel = csrc.KERNELS[name]
    reached, todo = set(), [kernel.source]
    while todo:
        for h in includes(todo.pop()) - reached:
            reached.add(h)
            todo.append(h)
    assert reached == set(kernel.headers)
