"""Multi-round federated simulation CLI of the port (counterpart of
``repro/launch/sim.py``).

It takes the reference ``sim`` flags that the port's path honours, with
the same names and defaults, and like the reference it trains the arch's
smoke config.  It runs on the card; ``run_sim(args, device="cpu")`` runs
it on the CPU from Python.

  PYTHONPATH=src python -m repro_torch.launch.sim --clients 4 --rounds 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import aggregation, latency, rounds
from repro_torch.core.latency import ChannelModel


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--algorithm", choices=rounds.ALGORITHMS,
                    default="fedpairing")
    ap.add_argument("--engine", choices=rounds.ENGINES, default="vmapped")
    ap.add_argument("--pairing", choices=tuple(rounds.PAIRINGS),
                    default="fedpairing",
                    help="Table-I pairing mechanism")
    ap.add_argument("--pair-policy", default="", metavar="POLICY",
                    help="pairing policy (generalizes --pairing): "
                         "paper-weight | random | location | compute | "
                         "greedy-cost | blossom-cost")
    ap.add_argument("--split-policy", default="paper", metavar="POLICY",
                    help="per-pair split-point policy: "
                         "paper | fixed:K | latency-opt")
    ap.add_argument("--replan-threshold", type=float, default=0.0,
                    metavar="REL",
                    help="keep the previous round's pairing while channel "
                         "drift moved its objective less than this "
                         "relative amount (0 = re-pair every round)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batches-per-round", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="cohort fraction sampled each round")
    ap.add_argument("--drift", type=float, default=0.0, metavar="SIGMA_M",
                    help="per-round client position random walk (meters)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--aggregation", choices=["paper", "fedavg"],
                    default="paper")
    ap.add_argument("--agg-policy", choices=list(aggregation
                                                 .AGG_POLICY_SPECS),
                    default="mean")
    ap.add_argument("--no-overlap-boost", action="store_true")
    ap.add_argument("--bucket-granularity", type=int, default=1)
    ap.add_argument("--server-cut", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="", metavar="PATH",
                    help="dump the round trace as JSON")
    return ap


def run_sim(args, device="cuda") -> rounds.RoundState:
    cfg = get_smoke_config(args.arch)
    rc = rounds.RoundConfig(
        algorithm=args.algorithm, engine=args.engine,
        pair_mechanism=args.pairing, pair_policy=args.pair_policy,
        split_policy=args.split_policy,
        replan_threshold=args.replan_threshold, rounds=args.rounds,
        batches_per_round=args.batches_per_round,
        participation=args.participation, drift_sigma_m=args.drift,
        lr=args.lr, aggregation=args.aggregation,
        agg_policy=args.agg_policy,
        overlap_boost=not args.no_overlap_boost,
        bucket_granularity=args.bucket_granularity,
        server_cut=args.server_cut, seed=args.seed)
    fleet = latency.make_fleet(n=args.clients, seed=args.seed)
    workload = latency.workload_from_arch(
        cfg, seq_len=args.seq, batch_size=args.batch,
        batches_per_epoch=args.batches_per_round, local_epochs=1)
    driver = rounds.RoundDriver(
        cfg, rc, fleet, chan=ChannelModel(), workload=workload,
        batch_fn=rounds.make_lm_batch_fn(cfg, args.clients, args.batch,
                                         args.seq, args.seed, device=device),
        device=device)
    print(f"[sim] {args.algorithm}/{args.engine} on {device}: "
          f"{args.clients} clients, W={cfg.num_layers}, "
          f"participation={args.participation}, drift={args.drift}m, "
          f"pair_policy={rc.resolved_pair_policy}")
    state = driver.init_state()
    for _ in range(args.rounds):
        t0 = time.time()
        state = driver.run_round(state)
        r = state.history[-1]
        print(f"  round {r.round}: cohort={list(r.cohort)} "
              f"pairs={list(r.pairs)} loss={r.mean_loss:.4f} "
              f"sim={r.sim_round_s:.1f}s (total {r.sim_total_s:.1f}s, "
              f"{'replanned' if r.replanned else 'kept plan'}, "
              f"{time.time() - t0:.1f}s wall)")
    print(f"[sim] simulated wall-clock for {args.rounds} rounds: "
          f"{state.sim_time_s:.1f}s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args),
                       "rounds": [dataclasses.asdict(r)
                                  for r in state.history],
                       "sim_total_s": state.sim_time_s}, f, indent=2)
            f.write("\n")
        print(f"[sim] trace written to {args.json}")
    return state


def main() -> None:
    run_sim(build_parser().parse_args())


if __name__ == "__main__":
    main()
