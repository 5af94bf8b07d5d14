"""The port's user examples (``python -m repro_torch.examples.*``) run end to
end on the CPU through their ``main(argv)``, as a user starts them."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import churn_demo, quickstart


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The runs here are many small products, which torch's thread pool
    slows down when several test processes share the cores: run them on
    one thread, and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_batched_int8_windows(tmp_path, capsys):
    out = tmp_path / "run.jsonl"
    quickstart.main(["--engine", "vectorized", "--scan-rounds", "5", "--wire-dtype", "int8",
                     "--metrics-out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    rows = [ln.split() for ln in text.splitlines() if ln.strip()[:1].isdigit()]
    assert [int(r[0]) for r in rows] == list(range(10))
    assert all(0.0 <= float(v) <= 1.0 for r in rows for v in r[1:])
    assert "accuracy drop due to decentralisation" in text
    assert "device dispatches: 2 for 10 rounds" in text  # two windows of 5
    lines = out.read_text().splitlines()
    assert len(lines) == 1 + 10  # the meta line, then one row a round
    assert json.loads(lines[0])["meta"]["wire_dtype"] == "int8"


def test_churn_demo_batched_against_scalar(capsys):
    churn_demo.main(["--engine", "vectorized", "--scan-rounds", "7", "--device", "cpu"])
    text = capsys.readouterr().out
    assert sum(ln.startswith("round ") for ln in text.splitlines()) == 14
    assert "partition coverage preserved" in text
    assert "scalar-oracle check" in text


def test_examples_default_to_cuda():
    for mod in (quickstart, churn_demo):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.main([])
