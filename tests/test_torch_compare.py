"""The kernel comparison tool's ablations against the sources they cut.

``kernels/compare.py`` times parts of the bf16 flash kernel alone by
editing one line of its key-tile loop (``ABLATIONS``).  Each edited line
must appear exactly once in the package's kernel and in the variant that
shares its loop, or the ablation would time something else; the tool
refuses a source without the line.
"""
import types
from pathlib import Path

import pytest

from repro_torch.kernels import compare

KERNELS = Path(compare.__file__).resolve().parent
SOURCES = [KERNELS / "csrc" / "flash_attention.cu",
           KERNELS / "variants" / "flash_attention_rows32.cu"]


@pytest.mark.parametrize("cut", sorted(compare.ABLATIONS))
@pytest.mark.parametrize("source", SOURCES, ids=lambda p: p.name)
def test_ablation_line_appears_once(source, cut):
    old, new = compare.ABLATIONS[cut]
    text = source.read_text()
    assert text.count(old) == 1
    assert text.replace(old, new).count(new) == 1


def test_ablation_refuses_a_source_without_its_line(tmp_path):
    cu = tmp_path / "other.cu"
    cu.write_text("// no key-tile loop here\n")
    args = types.SimpleNamespace(tree=[f"base={tmp_path}"],
                                 flash=[f"x=base:{cu}:copies_only"])
    with pytest.raises(ValueError, match="copies_only"):
        compare._versions(args)
