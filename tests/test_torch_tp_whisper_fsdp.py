"""whisper over a "model" mesh axis above 1 with the fsdp train step:
``tests/torch_tp_whisper_worker.py`` on a gloo (2, 2) mesh
(``test_torch_tp_whisper.py``'s checks; the parameters stored as each
rank's "data" shard of its "model" shard and gathered per layer, the tied
table twice), a file of its own so that the spawns run beside each other."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_whisper import check_mesh  # noqa: E402


def test_whisper_fsdp_on_a_2x2_mesh_equals_one_process(tmp_path):
    worst = check_mesh((2, 2), tmp_path)
    assert "whisper-base/train_enc12_tok12/params_beyond_tol_over_lr" in worst
