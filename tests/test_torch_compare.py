"""The kernel comparison tool's ablations against the sources they cut,
and its summary.

``kernels/compare.py`` times parts of a kernel alone, or a kernel without
one part, by editing lines of its source (``ABLATIONS``).  Each edited
line must appear exactly once in the source it names (for flash, also in
the variant that shares its key-tile loop), or the ablation would time
something else; the tool refuses a source without the line.  The summary
keeps each version's own kernels: an older tree times fewer.
"""
import types
from pathlib import Path

import pytest

from repro_torch.kernels import compare

KERNELS = Path(compare.__file__).resolve().parent
SOURCES = [KERNELS / "csrc" / "flash_attention.cu",
           KERNELS / "variants" / "flash_attention_rows32.cu"]
FLASH_CUTS = sorted(c for c, (src, _) in compare.ABLATIONS.items()
                    if src == "flash_attention.cu")
OTHER_CUTS = sorted(c for c, (src, _) in compare.ABLATIONS.items()
                    if src != "flash_attention.cu")


@pytest.mark.parametrize("cut", FLASH_CUTS)
@pytest.mark.parametrize("source", SOURCES, ids=lambda p: p.name)
def test_ablation_line_appears_once(source, cut):
    (_, edits), text = compare.ABLATIONS[cut], source.read_text()
    for old, new in edits:
        assert text.count(old) == 1
        assert text.replace(old, new).count(new) == 1
    assert compare.ablate(text, "flash_attention.cu", cut) != text


@pytest.mark.parametrize("cut", OTHER_CUTS)
def test_kernel_ablation_lines_appear_once(cut):
    source, edits = compare.ABLATIONS[cut]
    text = (KERNELS / "csrc" / source).read_text()
    for old, _ in edits:
        assert text.count(old) == 1
    assert compare.ablate(text, source, cut) != text


def test_ablation_refuses_a_source_without_its_line(tmp_path):
    cu = tmp_path / "other.cu"
    cu.write_text("// no key-tile loop here\n")
    args = types.SimpleNamespace(tree=[f"base={tmp_path}"], ablate=[],
                                 flash=[f"x=base:{cu}:copies_only"])
    with pytest.raises(ValueError, match="copies_only"):
        compare._versions(args)


def test_groups_name_every_kernel_source():
    """``--only`` groups: one per CUDA source of the package."""
    assert sorted(compare.GROUPS.values()) == sorted(
        p.name for p in (KERNELS / "csrc").glob("*.cu"))


def test_summary_keeps_each_versions_own_kernels():
    def row(version, rnd, kernels):
        return {"version": version, "round": rnd, "build_s": 1.0,
                **{k: {"device_ms": ms, "single_ms": 2 * ms, "graph_ms": ms,
                       "max_abs_err": 0.0,
                       "library": {"device_ms": 9.0, "graph_ms": 8.0}}
                   for k, ms in kernels.items()}}
    rows = [row("new", 0, {"bwd/a": 1.0, "bwd/b": 3.0}),
            row("old", 0, {"bwd/a": 5.0}),
            row("old", 0, {"bwd/a": 6.0}),
            row("new", 0, {"bwd/a": 2.0, "bwd/b": 4.0})]
    got = compare.summarize(rows, ["new", "old"])
    assert sorted(got["new"]) == ["bwd/a", "bwd/b"]
    assert list(got["old"]) == ["bwd/a"]
    assert got["new"]["bwd/a"]["device_ms"] == [1.0, 2.0]
    assert got["old"]["bwd/a"]["single_ms"] == [10.0, 12.0]
    assert got["new"]["bwd/b"]["library_graph_ms"] == [8.0, 8.0]
    assert "library_single_ms" not in got["new"]["bwd/b"]


# three kernels of an nvcc -Xptxas -v report (sm_90a): a template kernel
# in an anonymous namespace, one with 32 bytes spilled, one over bf16
PTXAS = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash\
_attention_bwd_cu_04843d3013dq_mma_kernelILi192EEEvPK13__nv_bfloat16S3_S3_S3_\
PKfS5_PS1_NS_7StridesES7_S7_S7_S7_iiiiffiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 248 registers, used 1 barriers
ptxas info    : Function properties for something else
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash\
_attention_bwd_cu_04843d3014dq_simt_kernelILi128EEEvPKfS2_S2_S2_S2_S2_PfNS_7\
StridesES4_S4_S4_S4_iiiifiii' for 'sm_90a'
32 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash\
_attention_bwd_cu_04843d3013rowdot_kernelI13__nv_bfloat16EEvPKT_S4_PfNS_7\
StridesES6_iiix' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 29 registers, used 0 barriers
"""


def test_ptxas_summary_names_each_kernel_with_its_registers_and_spills():
    from repro_torch.kernels import _build
    assert _build.ptxas_summary(PTXAS) == [
        "dq_mma_kernel<192>: 0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads; Used 248 registers, used 1 barriers",
        "dq_simt_kernel<128>: 32 bytes stack frame, 32 bytes spill stores, "
        "32 bytes spill loads; Used 128 registers, used 1 barriers, 32 "
        "bytes cumulative stack size",
        "rowdot_kernel<bf16>: 0 bytes stack frame, 0 bytes spill stores, 0 "
        "bytes spill loads; Used 29 registers, used 0 barriers"]


def _switch_dims(text):
    """The head dims of a flash source's ``switch (D)``: its ``case``
    lines up to the ``default``."""
    body = text[text.index("switch (D) {"):]
    body = body[:body.index("default:")]
    return {int(line.split("case ")[1].split(":")[0])
            for line in body.splitlines() if "case " in line}


@pytest.mark.parametrize(
    "source", [KERNELS / "csrc" / "flash_attention.cu",
               *sorted((KERNELS / "variants").glob("*.cu"))],
    ids=lambda p: p.name)
def test_flash_group_skips_exactly_the_head_dims_a_source_lacks(source):
    """The ``flash`` group runs every case whose D the version's source
    instantiates and skips the rest: the variants stop at D = 128, so
    the wide heads of ``checks.FLASH_CASES`` (160, 192) are skipped there
    and run in the package's own source."""
    from repro_torch.kernels import checks
    text = source.read_text()
    dims = _switch_dims(text)
    assert compare.head_dims(text) == dims
    cases, skipped = compare.flash_group_cases(text, checks.FLASH_CASES)
    assert len(cases) == len(compare.FLASH) + len(checks.FLASH_CASES)
    assert skipped == {n for n, c in cases.items() if c[5] not in dims}
    assert {cases[n][5] for n in skipped} == \
        {c[5] for c in cases.values()} - dims
    if source.parent.name == "variants":
        assert {cases[n][5] for n in skipped} == {160, 192}
    else:
        assert not skipped
