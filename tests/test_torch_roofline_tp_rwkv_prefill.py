"""rwkv6-7b's prefill (``prefill_32k``) counted on ``fake_world((16, 16))``
against the model-axis-1 step: ``test_torch_roofline_tp_rwkv.py``'s check
of the dot FLOPs and the collectives, in a file of its own (the chunked
scan's plain version loops over 2,048 chunks of 16, 10 s a count)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_roofline_tp import one_torch_thread  # noqa: E402,F401
from test_torch_roofline_tp_rwkv import check_rwkv6  # noqa: E402


def test_rwkv6_prefill_counts_on_the_production_mesh():
    check_rwkv6("prefill_32k")
