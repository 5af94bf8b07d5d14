"""The port's built prefill and decode steps against the reference's, for
the archs beyond the dense family's (``test_torch_serve_steps.py`` holds
those, the specs and the decode graph): the MoE pair (in float32), zamba2,
whisper and rwkv6. ``torch_serve_steps_ref`` says how and within what.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_smoke_mesh
from torch_serve_steps_ref import check_built_steps

ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b", "zamba2-1.2b", "whisper-base",
         "rwkv6-7b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pmesh():
    """The port's smoke mesh on the CPU (a one-process gloo group),
    destroyed after the module."""
    yield make_smoke_mesh("cpu")
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_built_steps_match_reference(arch, pmesh):
    check_built_steps(arch, pmesh)
