"""The K3 variants tool's edits still fit the kernel's source (CPU, torch
only): each variant of ``tools/k3_variants.py`` finds every text it edits in
K3's Hopper source, ``csrc/dwconv.cuh``, exactly once. The variants
themselves build and run only on the card."""

import pytest

from multitask_bonetumor_yolo_tpu_torch.tools import k3_variants


@pytest.mark.parametrize("name", sorted(k3_variants.EDITS))
def test_variant_edits_apply(name):
    text = k3_variants.SOURCE.read_text()
    edited = k3_variants.edited_source(name, text)
    assert (edited == text) == (not k3_variants.EDITS[name])
