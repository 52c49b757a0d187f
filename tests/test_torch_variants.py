"""kernel_variants.py's substitutions against the committed kernel sources (CPU only).

Each variant is the committed source with some text replaced; a replacement
whose text the source no longer holds would time the committed kernel under a
variant's name, so every one must match exactly once and change the file.
"""

import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "fypraytracer_tpu_torch", "csrc")


def _variants():
    spec = importlib.util.spec_from_file_location("kernel_variants", os.path.join(REPO, "kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kv = _variants()
CASES = [(family, name) for family, (_, _, bounds, variants) in kv.FAMILIES.items()
         for name in [f"{prefix}{n}" for prefix in bounds for n in (3, 5)] + list(variants)]


@pytest.mark.parametrize("family,name", CASES, ids=[f"{f}-{n}" for f, n in CASES])
def test_every_variant_changes_the_committed_source(family, name):
    _, _, bounds, variants = kv.FAMILIES[family]
    prefix = name.rstrip("0123456789")
    subs = bounds[prefix](int(name[len(prefix):])) if prefix in bounds and prefix != name else variants[name]
    for fn, old, new in subs:
        with open(os.path.join(CSRC, fn)) as f:
            text = f.read()
        out = kv.substitute(text, fn, old, new)
        assert out != text and new in out
        first = old if isinstance(old, str) else old[0]
        assert first not in out or first in new


def test_a_missing_text_is_refused():
    with pytest.raises(RuntimeError, match="has not exactly one"):
        kv.substitute("a b c", "x.cu", "d", "e")
    with pytest.raises(RuntimeError, match="has not exactly one"):
        kv.substitute("a b a", "x.cu", "a", "e")
    with pytest.raises(RuntimeError, match="has not exactly one"):
        kv.substitute("a b c", "x.cu", ("b", "a"), "e")
    assert kv.substitute("a b c d", "x.cu", ("b", "c"), "X") == "a X d"


def test_one_walk_replaces_stage1s_walks_with_one_site():
    with open(os.path.join(CSRC, "restir_gi.cu")) as f:
        text = f.read()
    out = text
    for fn, old, new in kv.FAMILIES["gi"][3]["onewalk"]:
        out = kv.substitute(out, fn, old, new)
    stage1 = lambda t: t[t.index("__device__ void stage1("):t.index("// ---- the second half")]  # noqa: E731
    assert stage1(text).count("tr.closest(") == 3
    assert stage1(out).count("tr.closest(") == 1
    assert "#pragma unroll 1" in stage1(out)


def _kernel(text, name, end):
    return text[text.index(name):text.index(end, text.index(name))]


def test_k4_walks_its_shadow_ray_at_one_site_and_unbounded_restores_one_walk():
    """K4's shadow ray: one walk site in a loop of at most two passes, the
    first bounded by the emitter; ``di unbounded`` puts back the one
    unbounded walk it replaced (the card test holds both bit for bit)."""
    with open(os.path.join(CSRC, "restir_di.cu")) as f:
        text = f.read()
    k4 = _kernel(text, "k4_shade(K4Params P) {", "\nEmitters emitters(")
    assert k4.count("trace_closest_wide1(") == 1 and "tr.closest(" not in k4
    assert "for (int pass = 0; pass < 2; ++pass)" in k4 and "t_max = kBig;" in k4
    out = text
    for fn, old, new in kv.FAMILIES["di"][3]["unbounded"]:
        out = kv.substitute(out, fn, old, new)
    k4 = _kernel(out, "k4_shade(K4Params P) {", "\nEmitters emitters(")
    assert k4.count("trace_closest_wide1(") == 1 and "pass" not in k4 and "l, kBig);" in k4


def test_k8_warps_walk_tiles_and_keep_one_ratio_a_level():
    """K8's warps own 8 x 4 pixel tiles (the grid counts the tiles), and a
    level keeps dg / g in place of g and dg."""
    with open(os.path.join(CSRC, "megakernel_diff.cu")) as f:
        text = f.read()
    k8 = _kernel(text, "diff_kernel(Params P) {", "\nusing DiffKernel")
    assert "(threadIdx.x & 7)" in k8 and "((threadIdx.x >> 3) & 3)" in k8
    assert "float rg[NL][3], ct[NL][3];" in k8
    assert re.search(r"\bd?g\[", k8) is None
    assert "((width + 7) / 8 * ((height + 3) / 4) + kWarps - 1) / kWarps" in text


def test_k3_reads_its_candidates_from_a_table_and_loop_restores_the_parents():
    """K3 evaluates p-hat once per emitter into a table, at one site in a
    loop that is not unrolled, and reads the candidates' values by compares
    (``phat_of``) where the list is short, else a p-hat a candidate, and
    ``p_prev`` evaluated; ``di loop`` puts back a p-hat a candidate, and
    ``di phat`` reads ``p_prev`` from the table too (the card test holds
    all three bit for bit)."""
    with open(os.path.join(CSRC, "restir_di.cu")) as f:
        text = f.read()
    k3 = _kernel(text, "k3_candidates(K3Params P) {", "\n// K4: blocks of")
    assert k3.count("p_hat(") == 3 and k3.count("phat_of(ph_e, cand)") == 1
    assert "const bool table = ne <= kPhatTable;" in k3 and "#pragma unroll 1" in k3
    for name, p_hats, tables in (("loop", 2, 0), ("phat", 3, 2)):
        out = text
        for fn, old, new in kv.FAMILIES["di"][3][name]:
            out = kv.substitute(out, fn, old, new)
        k3 = _kernel(out, "k3_candidates(K3Params P) {", "\n// K4: blocks of")
        assert k3.count("p_hat(") == p_hats and k3.count("phat_of(") == tables, name


def test_k7_reads_its_neighbours_eagerly_and_walks_lists_at_one_site():
    """K7 reads every row of a neighbour and computes its Jacobian before
    testing it (``K7Laps::kEager`` 2) while K5 keeps its chain of tests
    (0); ``gi chained`` and ``gi eager`` set K7's to 0 and 1; ``gi
    vislist`` walks each thread's list at one site in a loop that is not
    unrolled, over the set bits of a mask."""
    with open(os.path.join(CSRC, "restir_gi.cu")) as f:
        text = f.read()
    assert re.search(r"struct K5Laps \{[^}]*kEager = 0;", text) and re.search(r"struct K7Laps \{[^}]*kEager = 2;", text)
    for name, level in (("chained", 0), ("eager", 1)):
        out = kv.substitute(text, *kv.FAMILIES["gi"][3][name][0])
        assert re.search(r"struct K7Laps \{[^}]*kEager = %d;" % level, out)
    out = text
    for fn, old, new in kv.FAMILIES["gi"][3]["vislist"]:
        out = kv.substitute(out, fn, old, new)
    lists = _kernel(out, "__device__ uint32_t spatial_list(", "\n// The shade")
    assert lists.count("tr.visible(") == 1 and "#pragma unroll 1" in lists and "__ffs(" in lists
    assert "walked = spatial_list<K7Laps>(" in out and "walked = spatial<K7Laps>(" not in out
