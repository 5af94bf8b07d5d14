"""Fault-tolerance demo: agents leave, crash, disconnect and rejoin while
training continues (paper §2.2 Terminate + Fig 3b).

    PYTHONPATH=src python -m repro_torch.examples.churn_demo
    PYTHONPATH=src python -m repro_torch.examples.churn_demo --engine vectorized --scan-rounds 7
    PYTHONPATH=src python -m repro_torch.examples.churn_demo --metrics-out churn.jsonl --trace-out churn.trace.json
    PYTHONPATH=src python -m repro_torch.examples.churn_demo --device cpu

Both engines run the same membership-event schedule: the vectorized engine
replays each event round on its embedded scalar oracle and re-snapshots the
dense planes at the boundary, so with --engine vectorized the demo runs the
real schedule batched (optionally in CUDA-graph windows, a graph captured
anew in each span between events) and then re-runs it on the scalar engine
to check that the final accuracies match.
"""
import argparse
import dataclasses

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.p2p.network import LOSSY


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--engine", default="scalar", choices=["scalar", "vectorized"],
        help="round engine; vectorized runs the same churn schedule via "
        "event-boundary re-snapshot and is checked against the scalar oracle",
    )
    ap.add_argument(
        "--scan-rounds", type=int, default=0,
        help="vectorized only: run this many rounds per CUDA-graph window",
    )
    ap.add_argument(
        "--telemetry", action="store_true",
        help="record the per-round metric stream",
    )
    ap.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write the metric stream as JSONL (implies --telemetry)",
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

    x_tr, y_tr, x_te, y_te = synth_mnist(num_train=8000, num_test=2000, seed=0)
    shards = iid_split(x_tr, y_tr, num_agents=6, seed=0)

    churn = {
        3: [(5, "offline")],              # agent 5 loses connectivity
        5: [(4, "leave")],                # agent 4 leaves gracefully (Terminate)
        7: [(5, "online")],               # agent 5 rejoins (with memory)
        9: [(3, "crash")],                # agent 3 fails without handoff
    }
    cfg = SimConfig(
        num_agents=6, num_partitions=12, pi=3, rho=2, rounds=14,
        local_iters=8, churn=churn, memory=True, conditions=LOSSY,
        engine=args.engine, scan_rounds=args.scan_rounds,
        telemetry=telemetry, trace=bool(args.trace_out),
    )
    sim = make_simulation(cfg, shards, x_te, y_te, device=args.device)
    for m in sim.run():
        rnd = m["round"]
        events = ",".join(a for _, a in churn.get(rnd, [])) or "-"
        print(
            f"round {rnd:2d} active={m['active']} acc={m['acc_mean']:.4f} "
            f"(+/-{m['acc_std']:.4f}) churn=[{events}]"
        )
    if not sim.table.coverage():
        raise RuntimeError("partition coverage lost!")
    print("\npartition coverage preserved through leave/crash/rejoin ✓")
    if args.engine == "vectorized":
        print(f"device dispatches: {sim.device_dispatches} for {cfg.rounds} rounds")
        # same schedule on the scalar oracle: the re-snapshot path must land
        # on the identical final accuracy (weights match to float noise)
        ref = make_simulation(
            dataclasses.replace(
                cfg, engine="scalar", scan_rounds=0, telemetry=False, trace=False
            ),
            shards, x_te, y_te, device=args.device,
        )
        ref_acc = ref.run()[-1]["acc_mean"]
        acc = sim.history[-1]["acc_mean"]
        if abs(acc - ref_acc) >= 1e-6:
            raise RuntimeError(f"final accuracies differ: {acc} vs {ref_acc}")
        print(f"scalar-oracle check: final acc {acc:.4f} == {ref_acc:.4f} ✓")
    if args.metrics_out:
        sim.recorder.write_jsonl(
            args.metrics_out,
            meta={"example": "churn_demo", "engine": args.engine},
        )
        print(f"metrics stream -> {args.metrics_out}")
    if args.trace_out:
        sim.recorder.trace.write(args.trace_out)
        print(f"trace timeline -> {args.trace_out} (open in perfetto)")


if __name__ == "__main__":
    main()
