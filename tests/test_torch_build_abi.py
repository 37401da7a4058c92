"""The C entry points in ``kubeflow_tpu_torch/ops/csrc`` against the ctypes
signatures ``ops/_build.py`` binds them with.

ctypes does not read the C declarations: an argument list that disagrees
with the source passes silently, and a pointer bound as ``c_int`` is cut to
32 bits.  So every ``extern "C" int kft_*(...)`` declaration is parsed here
and held against ``_build.SIGNATURES``: the same functions, the same number
of arguments, and the same kind for each (pointer -> ``c_void_p``, ``int``
-> ``c_int``, ``float`` -> ``c_float``).  Runs on the CPU: no compiler.
"""
from __future__ import annotations

import ctypes
import re

import pytest

from kubeflow_tpu_torch.ops import _build

_DECL = re.compile(r'extern\s+"C"\s+int\s+(kft_\w+)\s*\(([^)]*)\)', re.S)
_KINDS = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float}


def _kind(param: str) -> str:
    """The ctypes kind of one C parameter declaration."""
    words = param.replace("*", " * ").split()
    if "*" in words:
        return "pointer"
    base = [w for w in words[:-1] if w not in ("const", "unsigned")]
    if base == ["int"]:
        return "int"
    if base == ["float"]:
        return "float"
    raise AssertionError(f"unexpected C parameter type in {param!r}")


def declarations() -> dict:
    """name -> (source file, [kind of each parameter])."""
    out = {}
    for src in _build.sources():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in _DECL.findall(text):
            assert name not in out, f"{name} declared twice"
            out[name] = (src.name, [_kind(p) for p in params.split(",")])
    return out


def test_sources_declare_exactly_the_bound_entry_points():
    assert set(declarations()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_source(name):
    decls = declarations()
    assert name in decls, f"{name} is bound but declared in no source"
    src, kinds = decls[name]
    bound = list(_build.SIGNATURES[name])
    assert len(bound) == len(kinds), (
        f"{name} ({src}): {len(kinds)} C parameters, {len(bound)} bound")
    for i, (kind, argtype) in enumerate(zip(kinds, bound)):
        assert argtype is _KINDS[kind], (
            f"{name} ({src}) parameter {i}: C {kind}, bound as "
            f"{argtype.__name__}")


def test_parser_reads_kinds():
    assert [_kind(p) for p in ("const void* q", "void* stream", "int b",
                               "float scale", "const int* seg")] == [
        "pointer", "pointer", "int", "float", "pointer"]
    with pytest.raises(AssertionError):
        _kind("double x")
