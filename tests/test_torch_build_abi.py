"""The C entry points in ``kubeflow_tpu_torch/ops/csrc`` against the ctypes
signatures ``ops/_build.py`` binds them with.

ctypes does not read the C declarations: an argument list that disagrees
with the source passes silently, and a pointer bound as ``c_int`` is cut to
32 bits.  So every ``extern "C" int kft_*(...)`` declaration is parsed here
and held against ``_build.SIGNATURES``: the same functions, the same number
of arguments, and the same kind for each (pointer -> ``c_void_p``, ``int``
-> ``c_int``, ``float`` -> ``c_float``).  The tile, ring and slice sizes
that ``chip_smoke.py``'s edge cases aim at are held against the
``constexpr`` sizes of the kernels' sources the same way, so a retiling
cannot leave the edge cases at stale lengths.  Runs on the CPU: no
compiler.
"""
from __future__ import annotations

import ast
import ctypes
import re
from pathlib import Path

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


# chip_smoke.py constant -> (source in ops/csrc, constexpr it names).
EDGE_CONSTANTS = {
    "K2_TILE": ("flash_attention_fwd.cu", "kBN"),
    "K2_STAGES": ("flash_attention_fwd.cu", "kStages"),
    "K3_ROWS": ("flash_attention_bwd.cu", "kDqRows"),
    "K3_KEYS": ("flash_attention_bwd.cu", "kDqKeys"),
    "K3_STAGES": ("flash_attention_bwd.cu", "kDqStages"),
    "K4_KEYS": ("flash_attention_bwd.cu", "kDkvKeys"),
    "K4_ROWS": ("flash_attention_bwd.cu", "kDkvRows"),
    "K4_STAGES": ("flash_attention_bwd.cu", "kDkvStages"),
    "K5_SLICE": ("flash_decode.cu", "kDecodeSlice"),
    "K5_CLUSTER": ("flash_decode.cu", "kDecodeCluster"),
    "K5_CHUNK": ("flash_decode.cu", "kDecodeChunk"),
    "K5_STAGES": ("flash_decode.cu", "kDecodeStages"),
}
_CONSTEXPR = re.compile(r"constexpr\s+int\s+(k\w+)\s*=\s*(\d+)\s*;")


def smoke_constants() -> dict:
    """The module-level integer constants K<n>_* of chip_smoke.py, read
    from its source (not imported)."""
    path = Path(_build.__file__).resolve().parents[2] / "chip_smoke.py"
    out = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, ast.Assign):
            continue
        targets = node.targets[0]
        names = (targets.elts if isinstance(targets, ast.Tuple)
                 else [targets])
        values = (node.value.elts if isinstance(node.value, ast.Tuple)
                  else [node.value])
        for name, value in zip(names, values):
            if (isinstance(name, ast.Name) and re.fullmatch(r"K\d_\w+",
                                                            name.id)
                    and isinstance(value, ast.Constant)):
                out[name.id] = value.value
    return out


def source_constants(name: str) -> dict:
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
    found = {}
    for const, value in _CONSTEXPR.findall(text):
        assert const not in found, f"{const} defined twice in {name}"
        found[const] = int(value)
    return found


def test_smoke_edge_constants_are_all_mapped():
    assert set(smoke_constants()) == set(EDGE_CONSTANTS)


@pytest.mark.parametrize("const", sorted(EDGE_CONSTANTS))
def test_smoke_edges_aim_at_the_kernel_tiles(const):
    src, name = EDGE_CONSTANTS[const]
    found = source_constants(src)
    assert name in found, f"{src} defines no constexpr int {name}"
    assert smoke_constants()[const] == found[name], (
        f"chip_smoke.py {const} = {smoke_constants()[const]}, "
        f"{src} {name} = {found[name]}")


# ops/cuda/rms_norm.py constant -> the rms_norm.cu constexpr it mirrors:
# the launch shape that bounds d and sizes the backward's grid and
# workspace.
RMS_NORM_CONSTANTS = {
    "MAX_WARPS_PER_ROW": "kWarpsPerBlock",
    "VECS_PER_LANE": "kVecsPerLane",
    "BWD_BLOCKS_PER_SM": "kBwdBlocksPerSm",
}


@pytest.mark.parametrize("const", sorted(RMS_NORM_CONSTANTS))
def test_rms_norm_wrapper_constants_match_the_kernel(const):
    from kubeflow_tpu_torch.ops.cuda import rms_norm as krms

    name = RMS_NORM_CONSTANTS[const]
    found = source_constants("rms_norm.cu")
    assert name in found, f"rms_norm.cu defines no constexpr int {name}"
    assert getattr(krms, const) == found[name], (
        f"ops/cuda/rms_norm.py {const} = {getattr(krms, const)}, "
        f"rms_norm.cu {name} = {found[name]}")
