"""The kernel comparison tool's ablations against the sources they cut.

``kernels/compare.py`` times parts of a kernel alone, or a kernel without
one part, by editing lines of its source (``ABLATIONS``).  Each edited
line must appear exactly once in the source it names (for flash, also in
the variant that shares its key-tile loop), or the ablation would time
something else; the tool refuses a source without the line.
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
