"""The C interface of the port's CUDA sources against the ctypes types the
wrappers call it with, on the CPU (no card, no ``nvcc``).

``kernels/cuda_build.SIGNATURES`` holds, for every ``extern "C"`` entry
point of ``csrc/*.cu``, the ctypes of its parameters in order;
``cuda_build.load`` (and ``bind``, for a library built another way) sets
them as the function's ``argtypes``.  A wrong count or order would pass
a pointer as an int or shift every later argument, which shows only on
the card; here each declaration is read from its source and held against
the table.
"""
import ctypes
import os
import re
import types

import pytest

from repro_torch.kernels import cuda_build

_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}
ENTRY_POINTS = [(src, name) for src, fns in sorted(
    cuda_build.SIGNATURES.items()) for name in sorted(fns)]


def _ctype(param: str):
    """The ctypes type of one C parameter: any pointer is ``c_void_p``."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    return _SCALARS[decl.rsplit(" ", 1)[0].replace("const ", "")]


def _declared(source: str) -> dict:
    """``{entry point: parameter ctypes}`` read from ``source``."""
    with open(os.path.join(cuda_build.CSRC, source)) as f:
        text = f.read()
    return {name: tuple(_ctype(p) for p in params.split(","))
            for name, params in _DECL.findall(text)}


def test_every_source_has_its_entry_points_in_the_table():
    sources = sorted(f for f in os.listdir(cuda_build.CSRC)
                     if f.endswith(".cu"))
    assert sources == sorted(cuda_build.SIGNATURES)
    for src in sources:
        assert sorted(_declared(src)) == sorted(cuda_build.SIGNATURES[src]), \
            src


@pytest.mark.parametrize("source,name", ENTRY_POINTS,
                         ids=[f"{s}:{n}" for s, n in ENTRY_POINTS])
def test_signature_matches_the_declaration(source, name):
    want = _declared(source)[name]
    got = cuda_build.SIGNATURES[source][name]
    assert len(got) == len(want), (name, len(got), len(want))
    assert got == want, name


@pytest.mark.parametrize("source", sorted(cuda_build.SIGNATURES))
def test_bind_sets_the_table_as_argtypes(source):
    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace()
        for name in cuda_build.SIGNATURES[source]})
    assert cuda_build.bind(lib, source) is lib
    for name, args in cuda_build.SIGNATURES[source].items():
        fn = getattr(lib, name)
        assert fn.argtypes == list(args) and fn.restype is ctypes.c_int


def test_parameter_parsing():
    assert _ctype(" const void* g") is ctypes.c_void_p
    assert _ctype("\n    long long d") is ctypes.c_longlong
    assert _ctype("float thres") is ctypes.c_float
    assert _ctype("int e_bf16") is ctypes.c_int
    assert _ctype("const long long* enc") is ctypes.c_void_p
