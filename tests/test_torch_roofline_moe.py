"""The dot FLOPs of the port's built train, prefill and decode steps
against the reference's ``analyze_hlo_text`` of the same functions
(``torch_roofline_ref``), for the MoE pair (granite-moe, deepseek-v2-lite),
each short of the reference's by ``expected_gap``: the reference's
grouped combine einsum. Witness: outside a mesh context the port's MoE
layers take the grouped path, whose combine is that einsum, and its
prefill and decode then count exactly the reference's FLOPs.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_roofline_ref import (
    B,
    KINDS,
    S,
    expected_gap,
    meshless_flops,
    moe_combine_flops,
    port_flops,
    ref_flops,
)

MOE = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_dot_flops_match_reference_but_the_combine(arch, kind):
    pytest.importorskip("jax")
    want = ref_flops(arch, kind)
    gap = expected_gap(arch, kind)
    assert gap > 0
    assert port_flops(arch, kind) == want - gap
    tokens = B if kind == "decode" else B * S
    assert gap == (2 if kind == "train" else 1) * moe_combine_flops(arch, tokens)
    if kind != "train":
        assert meshless_flops(arch, kind) == want
