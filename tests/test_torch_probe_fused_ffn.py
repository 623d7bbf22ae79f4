"""`m3p_tpu_torch.probe_fused_ffn` builds its variants of csrc/fused_ffn.cu
by exact substitutions: each must still apply to the committed source, and
the ptxas reading must parse (no card or toolkit needed)."""

import pytest

from m3p_tpu_torch import probe_fused_ffn as probe
from m3p_tpu_torch.ops import _build

PTXAS = """\
ptxas info    : Compiling entry function '_ZN2cl27fused_ffn_ln_cluster_kernelILi5EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2cl27fused_ffn_ln_cluster_kernelILi5EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2cl27fused_ffn_ln_cluster_kernelILi6EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2cl27fused_ffn_ln_cluster_kernelILi6EEvPKf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 175 registers, used 1 barriers
"""


@pytest.mark.parametrize("name", sorted(probe.VARIANTS))
def test_each_variant_applies_to_the_committed_source(name):
    source = (_build.CSRC / "fused_ffn.cu").read_text()
    got = probe.variant_source(name, source)
    assert (got == source) == (name == "shipped")
    for old, new in probe.VARIANTS[name]:
        assert new in got


def test_a_variant_whose_text_is_gone_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        probe.variant_source("ring3", "constexpr int kStages = 3;")


def test_registers_read_the_named_kernel():
    assert probe.registers(PTXAS, "cluster_kernelILi6E") == {
        "registers": 175, "spill_bytes": 16}
    assert probe.registers(PTXAS, "cluster_kernelILi5E") == {
        "registers": 160, "spill_bytes": 0}
