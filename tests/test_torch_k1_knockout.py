"""The K1 knockout tool's edits still fit the kernel's source (CPU, torch
only): each variant of ``tools/k1_knockout.py`` finds every text it edits in
K1's Hopper source, ``csrc/convnext_block_h.cuh``, exactly once. The variants themselves build and
run only on the card."""

import pytest

from multitask_bonetumor_yolo_tpu_torch.tools import k1_knockout


@pytest.mark.parametrize("name", sorted(k1_knockout.EDITS))
def test_knockout_edits_apply(name):
    text = k1_knockout.SOURCE.read_text()
    edited = k1_knockout.edited_source(name, text)
    assert (edited == text) == (not k1_knockout.EDITS[name])
