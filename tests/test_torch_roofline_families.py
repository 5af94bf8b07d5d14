"""The dot FLOPs of the port's built train, prefill and decode steps
against the reference's ``analyze_hlo_text`` of the same functions
(``torch_roofline_ref``), for gemma3 (sliding windows), whisper
(encoder-decoder) and rwkv6: equal, but rwkv6's decode step, where the
reference's bonus term is a dot (``expected_gap``, witnessed here).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from torch_roofline_ref import B, KINDS, expected_gap, port_flops, ref_flops

ARCHS = ("gemma3-1b", "whisper-base", "rwkv6-7b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_reference(arch, kind):
    pytest.importorskip("jax")
    gap = expected_gap(arch, kind)
    assert (gap > 0) == (arch == "rwkv6-7b" and kind == "decode")
    assert port_flops(arch, kind) == ref_flops(arch, kind) - gap


def test_rwkv6_bonus_einsum_is_a_dot_in_the_reference():
    """The witness of rwkv6's decode gap: the reference's bonus term
    ``einsum("bhk,hk,bhk,bhv->bhv")`` alone holds 2 B H K dot FLOPs in its
    HLO (the port's is elementwise: no product)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.roofline.hlo_cost import analyze_hlo_text

    b = get_config("rwkv6-7b", reduced=True).groups[0].blocks[0].rwkv
    H, K = b.n_heads, b.head_dim
    r, k, v = (jnp.ones((B, H, K)) for _ in range(3))
    u = jnp.ones((H, K))
    fn = jax.jit(lambda r, u, k, v: jnp.einsum("bhk,hk,bhk,bhv->bhv", r, u, k, v))
    assert analyze_hlo_text(fn.lower(r, u, k, v).compile().as_text()).flops == 2 * B * H * K
    n_time = sum(g.repeat for g in get_config("rwkv6-7b", reduced=True).groups)
    assert expected_gap("rwkv6-7b", "decode") == n_time * 2 * B * H * K
