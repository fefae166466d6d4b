"""The C interface of the port's CUDA sources against ``ops/_kernels.py``.

The kernels are plain C entry points loaded with ctypes, and ctypes passes
an argument as ``argtypes`` declares it: a pointer declared as a C int is
cut to 32 bits without a word.  These tests parse the ``extern "C"``
definitions of every ``sublinear_tpu_torch/csrc/*.cu`` and hold each to its
entry in ``_kernels.SIGNATURES``: the same functions, the same number of
arguments, a ``c_void_p`` wherever the C side takes a pointer, ``c_int``
for an ``int`` and ``c_float`` for a ``float``.  They read the sources
only: no nvcc, no card.
"""
import ctypes
import re

import pytest

from sublinear_tpu_torch.ops import _kernels

SOURCES = sorted(_kernels.CSRC.glob("*.cu"))
ERROR_STRING = "slt_error_string"
SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float}
DEFINITION = re.compile(
    r"^(int|const char\s*\*)\s*(slt_\w+)\s*\(([^)]*)\)\s*\{", re.M)


def exported(source):
    """{name: (return type, [parameter declarations])} of the functions
    defined in the source's extern "C" block."""
    text = source.read_text()
    start = text.index('extern "C" {')
    out = {}
    for ret, name, params in DEFINITION.findall(text[start:]):
        decls = [" ".join(p.split()) for p in params.split(",") if p.strip()]
        out[name] = (ret.replace(" ", ""), decls)
    return out


def ctype_of(decl):
    """The ctypes type a parameter declaration must be passed as."""
    if "*" in decl:
        return ctypes.c_void_p
    return SCALARS[decl.rsplit(" ", 1)[0].replace("const ", "")]


def test_every_source_has_signatures():
    assert SOURCES
    assert {s.stem for s in SOURCES} == set(_kernels.SIGNATURES)


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: s.stem)
def test_exports_match_signatures(source):
    """The entry points a source exports are those SIGNATURES declares,
    besides slt_error_string (int -> const char*), which every library
    has and library() binds by hand."""
    funcs = exported(source)
    assert funcs.pop(ERROR_STRING) == ("constchar*", ["int code"])
    assert set(funcs) == set(_kernels.SIGNATURES[source.stem])
    assert all(ret == "int" for ret, _ in funcs.values())


@pytest.mark.parametrize("stem,name", [
    (stem, name) for stem, fns in sorted(_kernels.SIGNATURES.items())
    for name in sorted(fns)])
def test_argtypes_match_c_parameters(stem, name):
    _, decls = exported(_kernels.CSRC / f"{stem}.cu")[name]
    argtypes = _kernels.SIGNATURES[stem][name]
    assert len(argtypes) == len(decls), decls
    for i, (decl, declared) in enumerate(zip(decls, argtypes)):
        assert declared is ctype_of(decl), (i, decl, declared)


def test_parser_reads_pointers_and_scalars():
    """The parser itself, on the declarations the sources use."""
    assert ctype_of("const float* diag") is ctypes.c_void_p
    assert ctype_of("void* stream") is ctypes.c_void_p
    assert ctype_of("double* res2") is ctypes.c_void_p
    assert ctype_of("int iters") is ctypes.c_int
    assert ctype_of("float alpha") is ctypes.c_float
