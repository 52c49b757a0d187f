"""The C interface of the port's CUDA sources against its ctypes bindings.

Every ``extern "C" int fyp_*(...)`` entry in ``fypraytracer_tpu_torch/csrc``
is bound by ``ops/kernels.py::load`` with the ``argtypes`` its Python
caller hands over.  ctypes trusts those: a pointer bound as an int is cut
to 32 bits, a float passed where the entry takes an int is read as its
bits, and one parameter too few shifts every later one.  The sources build
only on a card, so these tests read the prototypes from the text and hold
each binding (the port's modules, ``chip_smoke.py``, the card tests) to its
entry, parameter by parameter: a pointer as ``c_void_p``, an ``int`` as
``c_int``, an ``unsigned int`` as ``c_uint``, a ``float`` as ``c_float``.
"""

import ast
import ctypes
import importlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "fypraytracer_tpu_torch", "csrc")

_CTYPE_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_uint: "unsigned", ctypes.c_float: "float"}


def _param_kind(param: str) -> str:
    """The kind of one C parameter declaration: pointer, int, unsigned or
    float."""
    if "*" in param:
        return "pointer"
    words = param.replace("const", " ").split()[:-1]       # the type, without the name
    kinds = {("int",): "int", ("unsigned", "int"): "unsigned", ("unsigned",): "unsigned", ("float",): "float"}
    if tuple(words) not in kinds:
        raise AssertionError(f"a parameter of a type these tests do not know: {param!r}")
    return kinds[tuple(words)]


def c_entries() -> dict:
    """{entry: [kind of each parameter]} of every ``extern "C" int fyp_*``
    in the sources."""
    out = {}
    for fname in sorted(os.listdir(CSRC)):
        if not fname.endswith((".cu", ".cuh")):
            continue
        text = re.sub(r"//[^\n]*", "", open(os.path.join(CSRC, fname)).read())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(fyp_\w+)\s*\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            assert m.group(1) not in out, f"{m.group(1)} is defined twice"
            out[m.group(1)] = [_param_kind(p) for p in params]
    return out


# the Python files that bind the entries, as (path, module to evaluate names in)
BINDERS = [
    ("fypraytracer_tpu_torch/ops/kernels.py", "fypraytracer_tpu_torch.ops.kernels"),
    ("fypraytracer_tpu_torch/ops/traverse.py", "fypraytracer_tpu_torch.ops.traverse"),
    ("fypraytracer_tpu_torch/render/megakernel.py", "fypraytracer_tpu_torch.render.megakernel"),
    ("fypraytracer_tpu_torch/render/megakernel_restir.py", "fypraytracer_tpu_torch.render.megakernel_restir"),
    ("fypraytracer_tpu_torch/render/megakernel_restir_gi.py", "fypraytracer_tpu_torch.render.megakernel_restir_gi"),
    ("fypraytracer_tpu_torch/render/megakernel_diff.py", "fypraytracer_tpu_torch.render.megakernel_diff"),
    ("chip_smoke.py", None),
    ("tests/test_torch_cuda.py", None),
]


def py_bindings() -> list:
    """(entry, [kind of each argtype], where) of every ``load(lib, "fyp_...",
    argtypes)`` call in ``BINDERS``, the argtypes evaluated in the binding
    module's namespace (a module constant) or from ``ctypes`` alone (a list
    written at the call)."""
    out = []
    for path, module in BINDERS:
        tree = ast.parse(open(os.path.join(REPO, path)).read())
        names = dict(vars(importlib.import_module(module))) if module else {}
        names["ctypes"] = ctypes
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and len(node.args) == 3):
                continue
            f = node.func
            if not ((isinstance(f, ast.Attribute) and f.attr == "load") or (isinstance(f, ast.Name) and f.id == "load")):
                continue
            sym = node.args[1]
            if not (isinstance(sym, ast.Constant) and isinstance(sym.value, str) and sym.value.startswith("fyp_")):
                continue
            argtypes = eval(compile(ast.Expression(node.args[2]), path, "eval"), names)   # noqa: S307
            out.append((sym.value, [_CTYPE_KIND.get(t, repr(t)) for t in argtypes], f"{path}:{node.lineno}"))
    return out


ENTRIES = c_entries()
BINDINGS = py_bindings()


def test_every_entry_is_bound_and_every_binding_has_an_entry():
    """Each C entry has a ctypes binding, and each binding names an entry
    of the sources (none left behind by a renamed or removed entry)."""
    bound = {name for name, _, _ in BINDINGS}
    assert sorted(set(ENTRIES) - bound) == []
    assert sorted(bound - set(ENTRIES)) == []
    assert {"fyp_restir_di_k3", "fyp_restir_di_k4", "fyp_restir_gi", "fyp_megakernel_prepare"} <= set(ENTRIES)


@pytest.mark.parametrize("where", [w for _, _, w in BINDINGS])
def test_binding_matches_its_c_entry(where):
    """The argtypes at ``where`` have the entry's parameter count and, one
    by one, its kinds: a pointer is ``c_void_p`` (never an int that would
    cut it), ints and floats as declared."""
    name, kinds, _ = next(b for b in BINDINGS if b[2] == where)
    want = ENTRIES[name]
    assert len(kinds) == len(want), f"{name}: {len(kinds)} argtypes at {where}, the entry takes {len(want)}"
    bad = [(i, k, w) for i, (k, w) in enumerate(zip(kinds, want)) if k != w]
    assert bad == [], f"{name} at {where}: (parameter, bound as, declared) {bad}"


def test_restir_di_k4_takes_the_wide_records():
    """K4's entry takes the wide BVH's four arguments (nodes, triangles,
    overflow flag, stack depth) after the sky, and no threaded BVH: the
    camera and 7 ints and floats, 3 sky floats, 3 pointers and an int, the
    emissive table (8 pointers and a count), stage, state, accum and the
    stream."""
    want = (["pointer", "int", "int", "unsigned", "int", "int", "float", "int"] + ["float"] * 3
            + ["pointer"] * 3 + ["int"] + ["pointer"] * 8 + ["int"] + ["pointer"] * 4)
    assert ENTRIES["fyp_restir_di_k4"] == want


def test_diff_megakernel_takes_the_wide_records():
    """K8's entry takes the wide BVH's four arguments (nodes, triangles,
    overflow flag, stack depth) after the materials, and no threaded BVH:
    the camera, width, height, frame and bounces, 3 sky floats, the
    geometry (4 pointers and the triangle count), the materials (4
    pointers), 3 pointers and an int, target, loss, d_tri and the
    stream."""
    want = (["pointer", "int", "int", "unsigned", "int"] + ["float"] * 3 + ["pointer"] * 4 + ["int"]
            + ["pointer"] * 4 + ["pointer"] * 3 + ["int"] + ["pointer"] * 4)
    assert ENTRIES["fyp_diff_megakernel"] == want


def test_restir_gi_takes_no_threaded_bvh():
    """The ReSTIR GI entry (K5-K7) takes the wide BVH's four arguments after
    the texture and no threaded BVH: the kernel, camera and proj @ view,
    width, height, frame, tile, launch, bounces and neighbours, radius and
    history limit, temporal, 3 sky floats, 10 geometry and material
    pointers, the texture (a flag, 2 pointers and 5 ints), 3 pointers and
    an int, the 5 buffers and the stream."""
    want = (["int", "pointer", "pointer", "int", "int", "unsigned", "int", "int", "int", "int", "float", "float",
             "int"] + ["float"] * 3 + ["pointer"] * 10 + ["int"] + ["pointer"] * 2 + ["int"] * 5
            + ["pointer"] * 3 + ["int"] + ["pointer"] * 6)
    assert ENTRIES["fyp_restir_gi"] == want


def test_megakernel_takes_no_threaded_bvh():
    """K2's packing entry takes the wide BVH's four arguments (nodes,
    triangles, overflow flag, stack depth) after the texture, and no
    threaded BVH: the sampler and lanes, camera, width, height, slab start
    and size, bounces and samples, 3 sky floats, 10 geometry and material
    pointers, the texture (a flag, 2 pointers and 5 ints), 3 pointers and
    an int, the light tree (13 pointers and its depth), and the block it
    packs."""
    want = (["int", "int", "pointer"] + ["int"] * 6 + ["float"] * 3
            + ["pointer"] * 10 + ["int"] + ["pointer"] * 2 + ["int"] * 5 + ["pointer"] * 3 + ["int"]
            + ["pointer"] * 13 + ["int"] + ["pointer"])
    assert ENTRIES["fyp_megakernel_prepare"] == want


def test_megakernel_launch_takes_the_packed_block_and_the_frames():
    """A launch of K2 takes only what changes between launches: the block
    ``fyp_megakernel_prepare`` packed, the first frame (unsigned), the
    frame count, the output and the stream; the block's size is asked of
    the library, whose entry takes nothing."""
    assert ENTRIES["fyp_megakernel_launch"] == ["pointer", "unsigned", "int", "pointer", "pointer"]
    assert ENTRIES["fyp_megakernel_prepared_bytes"] == []
    assert "fyp_megakernel" not in ENTRIES


def test_megakernel_clocks_entry_is_bound_by_the_smoke_test():
    """K2's section clocks (built with ``-DFYP_K2_CLOCKS``) hand over their
    sums through an entry that takes the output and the stream, and
    ``chip_smoke.py::k2_attribution`` binds it."""
    assert ENTRIES["fyp_megakernel_clocks"] == ["pointer", "pointer"]
    assert [w.split(":")[0] for name, _, w in BINDINGS if name == "fyp_megakernel_clocks"] == ["chip_smoke.py"]


def test_restir_gi_clocks_entry_is_bound_by_the_smoke_test():
    """K5's and K6's section clocks (built with ``-DFYP_GI_CLOCKS``) hand over
    their sums through an entry that takes the output and the stream, and
    ``chip_smoke.py::gi_attribution`` binds it; the ReSTIR GI entry and its
    occupancy entry keep their parameters (the kernel, texturing, tile,
    launch shape and stack depth, and the two counts out)."""
    assert ENTRIES["fyp_restir_gi_clocks"] == ["pointer", "pointer"]
    assert [w.split(":")[0] for name, _, w in BINDINGS if name == "fyp_restir_gi_clocks"] == ["chip_smoke.py"]
    assert ENTRIES["fyp_restir_gi_occupancy"] == ["int"] * 5 + ["pointer"] * 2


@pytest.mark.parametrize("entry", ["fyp_diff_clocks", "fyp_restir_di_clocks"])
def test_diff_and_di_clocks_entries_are_bound_by_the_smoke_test(entry):
    """K8's and K4's section clocks and block spans (built with
    ``-DFYP_DIFF_CLOCKS`` and ``-DFYP_DI_CLOCKS``, csrc/clocks.cuh) hand
    over their sums and spans through an entry that takes both outputs,
    the blocks to copy and the stream, and ``chip_smoke.py``'s
    ``k8_attribution`` and ``di_attribution`` bind it; K4's and K8's own
    entries keep their parameters."""
    assert ENTRIES[entry] == ["pointer", "pointer", "int", "pointer"]
    assert [w.split(":")[0] for name, _, w in BINDINGS if name == entry] == ["chip_smoke.py"]
    assert len(ENTRIES["fyp_restir_di_k4"]) == 28 and len(ENTRIES["fyp_diff_megakernel"]) == 25


@pytest.mark.parametrize("entry", ["fyp_restir_di_k3_clocks", "fyp_restir_gi_k7_clocks"])
def test_k3_and_k7_clocks_entries_are_bound_by_the_smoke_test(entry):
    """K3's and K7's section clocks and block spans (built with
    ``-DFYP_DI_CLOCKS`` and ``-DFYP_GI_CLOCKS``; K7's sums end with its
    visibility-walk counters) hand them over through an entry that takes
    both outputs, the blocks to copy and the stream, as K4's does, and
    ``chip_smoke.py``'s ``di_attribution`` and ``k7_attribution`` bind it;
    K3's and the ReSTIR GI entry keep their parameters."""
    assert ENTRIES[entry] == ["pointer", "pointer", "int", "pointer"]
    assert [w.split(":")[0] for name, _, w in BINDINGS if name == entry] == ["chip_smoke.py"]
    assert len(ENTRIES["fyp_restir_di_k3"]) == 44 and len(ENTRIES["fyp_restir_gi"]) == 44


def test_parameter_kinds_are_read_as_declared():
    """The reader of the prototypes: pointers whatever their constness,
    ``unsigned int`` apart from ``int``; a type it does not know fails."""
    assert [_param_kind(p) for p in ("const void* cam", "void* out", "int* blocks", "int n", "unsigned int frame",
                                     "float radius", "const float* x")] == \
        ["pointer", "pointer", "pointer", "int", "unsigned", "float", "pointer"]
    with pytest.raises(AssertionError, match="do not know"):
        _param_kind("double x")
