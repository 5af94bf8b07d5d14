"""The IPLS train step on multi-process gloo meshes on the CPU: (data=2,
model=1) and (pod=2, data=2, model=1), one spawn of worker processes per
world size (``torch_sharded_worker.py``).

On every rank, after the steps, the mesh's run equals the same step run
in one process over the whole global batch: the parameters in full (after
LoadModel's all-gather), the optimizer state's owned slices (each rank
holds only its slice of each leaf: shapes checked), step and eps within
1e-5, the metrics within 1e-5 of max(1, |value|) (float32 gradient sums
over ranks in another order than one process's batch sums; measured max
|d| in the test's output).
Cases: a three-leaf model whose ZeRO-1 dims are 0, 1 and none, three steps
of Adam with clipping and ``accum_steps=2``, and without clipping;
internlm2-reduced in float32, one step through ``build_train_step`` with
SGD and clipping, and with AdamW, clipping and ``accum_steps=2``; each with
every agent participating and with the agents of data-parallel rank 1
dropped. And qwen2-vl-reduced (M-RoPE) on (data=2, model=1): one AdamW
step through ``build_train_step``, its positions3 split over the ranks on
dim 1.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import torch_sharded_worker as worker  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The spawned workers set one thread each; the parent only waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("world", [2, 4], ids=["data2", "pod2xdata2"])
def test_mesh_step_equals_one_process(world, tmp_path):
    import torch.multiprocessing as mp

    mp.start_processes(worker.run, args=(world, str(tmp_path)), nprocs=world,
                       join=True, start_method="spawn")
    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]
    assert all(g.keys() == gaps[0].keys() for g in gaps) and len(gaps[0]) == 8
    worst = max(v for g in gaps for v in g.values())
    print(f"world {world}: max |d| {worst:.3g}", gaps[0])
    assert worst <= worker.TOL


def test_mrope_train_step_equals_one_process(tmp_path):
    """qwen2-vl-reduced through build_train_step on a gloo mesh of two
    processes: each rank takes its half of positions3's dim 1 (the batch),
    and the step equals one process's over the whole batch."""
    import torch.multiprocessing as mp

    mp.start_processes(worker.run_mrope, args=(2, str(tmp_path)), nprocs=2, join=True,
                       start_method="spawn")
    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert all(g.keys() == {"mrope"} for g in gaps)
    worst = max(g["mrope"] for g in gaps)
    print(f"mrope: max |d| {worst:.3g}")
    assert worst <= worker.TOL
