"""Quickstart: decentralized federated training with IPLS in ~40 lines.

Boots 5 agents on the simulated IPFS substrate, trains the paper's MLP on a
synthetic MNIST-like dataset for 10 rounds, and compares against the
centralized FedAvg baseline.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --engine vectorized --scan-rounds 5
    PYTHONPATH=src python -m repro_torch.examples.quickstart --wire-dtype int8
    PYTHONPATH=src python -m repro_torch.examples.quickstart --metrics-out run.jsonl --trace-out run.trace.json
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

--wire-dtype int8 ships deltas and partition transfers as int8 codes with
per-block power-of-two scales and error feedback (~4x less wire traffic,
accuracy within noise of f32).

Choosing --scan-rounds: W > 1 runs W rounds as one CUDA-graph replay
(vectorized engine only): the host stages W rounds' inputs up front and the
card replays one captured window, so the per-round launch loop is paid once
per window. The first window of each length and evaluation pattern is
captured (one eager warm-up round, then the recording); W that divides
``rounds`` avoids capturing a second graph for the tail window. Metrics are
reported per round either way, and results are identical for any W.
"""
import argparse

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation, run_centralized


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--engine", default="scalar", choices=["scalar", "vectorized"],
        help="round engine: per-agent pubsub oracle or batched device calls",
    )
    ap.add_argument(
        "--scan-rounds", type=int, default=0,
        help="vectorized only: run this many rounds per CUDA-graph window",
    )
    ap.add_argument(
        "--wire-dtype", default="f32", choices=["f32", "int8"],
        help="wire transport: raw f32 or int8 + error feedback (~4x less traffic)",
    )
    ap.add_argument(
        "--telemetry", action="store_true",
        help="record the per-round metric stream",
    )
    ap.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write the metric stream as JSONL (implies --telemetry); "
        "summarize with `python -m repro_torch.telemetry.report PATH`",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write a Chrome trace-event JSON timeline (implies --telemetry); "
        "open at https://ui.perfetto.dev",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (the default; raises without a card) or cpu",
    )
    args = ap.parse_args(argv)
    telemetry = args.telemetry or bool(args.metrics_out or args.trace_out)

    # 1. data: 10k synthetic MNIST-like samples, split IID over 5 agents
    x_tr, y_tr, x_te, y_te = synth_mnist(num_train=10000, num_test=2000, seed=0)
    shards = iid_split(x_tr, y_tr, num_agents=5, seed=0)

    # 2. IPLS: 10 model partitions, each agent responsible for >=2 (pi),
    #    each partition replicated at most twice (rho)
    cfg = SimConfig(
        num_agents=5, num_partitions=10, pi=2, rho=2,
        rounds=10, local_iters=10, batch_size=128,
        engine=args.engine, scan_rounds=args.scan_rounds,
        wire_dtype=args.wire_dtype,
        telemetry=telemetry, trace=bool(args.trace_out),
    )
    sim = make_simulation(cfg, shards, x_te, y_te, device=args.device)
    history = sim.run()
    if args.metrics_out:
        sim.recorder.write_jsonl(
            args.metrics_out,
            meta={"example": "quickstart", "engine": args.engine,
                  "wire_dtype": args.wire_dtype},
        )
        print(f"metrics stream -> {args.metrics_out}")
    if args.trace_out:
        sim.recorder.trace.write(args.trace_out)
        print(f"trace timeline -> {args.trace_out} (open in perfetto)")

    # 3. centralized FedAvg reference on the same shards
    central = run_centralized(shards, x_te, y_te, rounds=10, local_iters=10, device=args.device)

    print(f"{'round':>5} {'IPLS acc':>10} {'central acc':>12}")
    for h, c in zip(history, central):
        print(f"{h['round']:>5} {h['acc_mean']:>10.4f} {c['acc_mean']:>12.4f}")
    drop = (central[-1]["acc_mean"] - history[-1]["acc_mean"]) * 1000
    print(f"\naccuracy drop due to decentralisation: {drop:.2f} per-mille")
    if args.engine == "vectorized":
        print(f"total bytes over the (simulated) wire: {sim._bytes_total/1e6:.1f} MB")
        print(f"device dispatches: {sim.device_dispatches} for {cfg.rounds} rounds")
    else:
        print(f"total bytes over the (simulated) wire: {sim.net.pubsub.total_bytes()/1e6:.1f} MB")


if __name__ == "__main__":
    main()
