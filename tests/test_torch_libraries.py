"""The port's one seam for native libraries (gens_torch/utils/libraries.py):
the build rule (hash-named libraries, headers in the hash, a rebuild only
after an edit), the binding from a declaration's table, every wrapper's
refusal of a device with no path, and the package's import graph: the
model knows no mesh code, ``utils/`` depends on nothing above it, and only
the seam opens a library or starts a compiler.

Imports neither jax nor gens_tpu; its one ``cuda`` test runs on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_libraries.py
"""

import ast
import ctypes
import os

import pytest
import torch

from gens_torch.ops import cascade_pe as k4
from gens_torch.ops import fused_mlp as k3
from gens_torch.ops import gather as gk
from gens_torch.ops import isosurface as k5
from gens_torch.ops import splat as k1
from gens_torch.ops import window_fwd as k2
from gens_torch.utils import libraries
from gens_torch.utils.profiling import counter

PKG = os.path.join(libraries.ROOT, "gens_torch")
SEAM = "utils/libraries.py"
COMPILERS = ("nvcc", "g++", "gcc", "c++", "clang", "clang++")


@pytest.mark.parametrize("source", ["sdf_mlp.cu", "gather_probe.cu"])
def test_tensor_core_sources_hash_their_header(source):
    assert libraries.source_files(f"{libraries.CSRC}/{source}") == sorted(
        [source, "hopper.cuh"])


def test_editing_a_header_changes_the_library_path(tmp_path):
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    source = str(tmp_path / "k.cu")
    assert libraries.source_files(source) == ["a.cuh", "b.cuh", "k.cu"]
    before = libraries.library_path(source)
    assert os.path.basename(before).startswith("libk_")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    after = libraries.library_path(source)
    assert after != before
    (tmp_path / "b.cuh").write_text("// b\n")
    assert libraries.library_path(source) == before


def test_libraries_link_dl_for_the_tensor_map_entry_point():
    assert "-ldl" in libraries.LINK_FLAGS
    assert "arch=compute_90a,code=sm_90a" in libraries.NVCC_FLAGS


def test_a_host_library_builds_binds_and_rebuilds_only_after_an_edit(
        tmp_path, monkeypatch):
    monkeypatch.setattr(libraries, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(libraries, "_loaded", {})
    (tmp_path / "k.h").write_text("#define K 40\n")
    (tmp_path / "k.cpp").write_text(
        '#include "k.h"\nextern "C" int add(int a, int b) '
        "{ return a + b + K; }\n")
    lib = libraries.Library(str(tmp_path / "k.cpp"),
                            {"add": (ctypes.c_int, [ctypes.c_int] * 2)})
    path, seconds, _ = libraries.build([lib])[lib.source]
    assert seconds is not None
    assert path == libraries.library_path(lib.source)
    assert os.path.dirname(path) == str(tmp_path / "build")
    assert os.path.basename(path).startswith("libk_")
    assert os.listdir(tmp_path / "build") == [os.path.basename(path)]
    assert libraries.build([lib])[lib.source] == (path, None, "")

    cdll = libraries.load(lib)
    assert cdll.add.restype is ctypes.c_int
    assert cdll.add(1, 2) == 43
    assert libraries.load(lib) is cdll

    (tmp_path / "k.h").write_text("#define K 50\n")
    edited, seconds, _ = libraries.build([lib])[lib.source]
    assert edited != path and seconds is not None
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) for p in (path, edited))

    (tmp_path / "k.cpp").write_text("int broken(\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        libraries.build([lib])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


WRAPPERS = {
    "K1": (lambda: k1.splat_bilinear(_meta(4, 2), _meta(4, 4), (8, 8)),
           "k1.launches"),
    "K2": (lambda: k2.bilerp_window_fwd(_meta(8, 8, 4), _meta(4, 2)),
           "k2.launches"),
    "K3": (lambda: k3.sdf_mlp_fused(k3.FoldedMLP([], [], 27, 40, 64),
                                    _meta(4, 27), _meta(4, 40)),
           "k3.launches"),
    "K4": (lambda: k4.cascade_pe(_meta(8, 3), [_meta(2, 2, 2, 4)], 1.0, 4,
                                 2), "k4.launches"),
    "K5": (lambda: k5.marching_tetrahedra_cuda(_meta(4, 4, 4)),
           "k5.launches"),
    "P1": (lambda: gk.row_gather_take(
        _meta(8, 4), _meta(3, dtype=torch.int32)), "p1.launches"),
    "P2": (lambda: gk.row_gather_take_along(
        _meta(8, 4), _meta(3, dtype=torch.int32)), "p2.launches"),
    "P3": (lambda: gk.onehot_gather(
        _meta(8, 4), _meta(3, dtype=torch.int32)), "p3.launches"),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wrapper_has_no_path_for_a_meta_tensor(kernel):
    call, launches = WRAPPERS[kernel]
    before = counter(launches)
    with pytest.raises(ValueError, match="has no path"):
        call()
    assert counter(launches) == before


def _modules():
    for folder, _, names in os.walk(PKG):
        for name in sorted(names):
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                rel = os.path.relpath(path, PKG).replace(os.sep, "/")
                with open(path) as f:
                    yield rel, ast.parse(f.read(), path)


def _imports(tree):
    """Every gens_torch module an ``import`` names, ``from a import b``
    counted as both ``a`` and ``a.b``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return {m for m in out if m.split(".")[0] == "gens_torch"}


def _under(module, packages):
    return any(module == p or module.startswith(p + ".") for p in packages)


# utils/preemption.py imports parallel/distributed.py to agree the flag
# across ranks: an upward arrow out of utils/ that this test leaves alone
FORBIDDEN = {
    "models/": ("gens_torch.mesh", "gens_torch.ops.isosurface"),
    "utils/": tuple(f"gens_torch.{p}" for p in
                    ("models", "mesh", "ops", "train", "eval")),
}


@pytest.mark.parametrize("folder", sorted(FORBIDDEN))
def test_import_graph_points_down(folder):
    bad = {rel: sorted(m for m in _imports(tree)
                       if _under(m, FORBIDDEN[folder]))
           for rel, tree in _modules() if rel.startswith(folder)}
    assert {k: v for k, v in bad.items() if v} == {}


def _native_calls(tree):
    """The ctypes opens and compiler names (string constants outside
    docstrings) in a module."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name in ("CDLL", "LoadLibrary", "PyDLL"):
                found.add(name)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs
              and os.path.basename(node.value) in COMPILERS):
            found.add(node.value)
    return found


def test_only_the_seam_opens_libraries_and_starts_compilers():
    found = {rel: _native_calls(tree) for rel, tree in _modules()}
    assert found.pop(SEAM) >= {"CDLL", "nvcc", "g++"}
    assert {k: v for k, v in found.items() if v} == {}


@pytest.mark.cuda
def test_first_cuda_load_builds_every_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    libraries.load(k1.LIBRARY)
    for lib in libraries.cuda_libraries():
        assert os.path.exists(libraries.library_path(lib.source)), lib.source
