"""End-to-end training CLI — a thin layer over the port's ``TrainSession``,
``repro.launch.train`` flag for flag, plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \
      --steps 200 --seq 256 --batch 32 --ckpt-dir /tmp/ckpt [--reduced] [--device cpu]

It runs on the card unless ``--device cpu`` is given.  ``--fail-at N`` and a
rerun of the same command drive the crash → resume path; ``--chaos-nan-at``,
``--fleet-replicas``, ``--chaos-lose-replica`` and ``--chaos-replica-nan``
the skip/rollback, consensus and elastic re-plan paths.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import stepfn
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.data import DataConfig
from repro_torch.session import TrainSession


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-size config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--gas", type=int, default=1)
    ap.add_argument("--zero", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (restart drill)")
    ap.add_argument("--chaos-nan-at", type=int, action="append", default=None,
                    help="inject NaN gradients at this data index "
                         "(repeatable; exercises skip/rollback recovery)")
    ap.add_argument("--fleet-replicas", type=int, default=0,
                    help="track N replicas in a FleetController (enables "
                         "elastic re-plan on replica loss / stragglers)")
    ap.add_argument("--chaos-lose-replica", action="append", default=None,
                    metavar="STEP:REPLICA",
                    help="inject replica loss at a loop step (repeatable; "
                         "exercises the elastic re-plan path)")
    ap.add_argument("--chaos-replica-nan", action="append", default=None,
                    metavar="INDEX:REPLICA",
                    help="poison ONE replica's gradients at a data index "
                         "(repeatable; exercises the skip-consensus vote)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    plan = ParallelismConfig(pp=args.pp, gas=max(args.gas, args.pp),
                             zero_stage=args.zero, dp=args.dp)
    tcfg = stepfn.TrainConfig(
        peak_lr=args.lr, total_steps=args.steps,
        warmup=max(1, args.steps // 10),
        compression=None if args.compression == "none" else args.compression)
    if args.fleet_replicas > 0:
        # simulated fleet on one host: force that many consensus replica
        # groups so the skip vote is exercised without a multi-device mesh
        from repro_torch.runtime.resilience import ResilienceConfig
        import dataclasses as _dc
        tcfg = _dc.replace(tcfg, resilience=ResilienceConfig(
            consensus_replicas=args.fleet_replicas))

    sess = TrainSession.from_recipe(
        args.arch, reduced=args.reduced, plan=plan, train_cfg=tcfg,
        data_cfg=DataConfig(seq_len=args.seq, global_batch=args.batch),
        device=args.device)
    for k, v in sess.advice.items():
        print(f"[advisor:{k}] {v}")
    print(f"[train] {sess.cfg.name}: {sess.n_params/1e6:.1f}M params, "
          f"plan={sess.plan}, device={sess.device}")

    def parse_pairs(items):
        return {int(a): int(b) for a, b in
                (s.split(":", 1) for s in (items or ()))}

    chaos = None
    if (args.fail_at is not None or args.chaos_nan_at
            or args.chaos_lose_replica or args.chaos_replica_nan):
        from repro_torch.runtime.chaos import FaultPlan
        chaos = FaultPlan(
            crash_at=args.fail_at,
            nan_grad_steps=tuple(args.chaos_nan_at or ()),
            gas=plan.gas,
            replicas=max(1, args.fleet_replicas, plan.dp),
            lose_replica=parse_pairs(args.chaos_lose_replica),
            replica_nan={i: (r,) for i, r in
                         parse_pairs(args.chaos_replica_nan).items()})

    fleet = None
    if args.fleet_replicas > 0:
        from repro_torch.runtime.fleet import FleetController
        fleet = FleetController(args.fleet_replicas)

    t0 = time.time()
    out = sess.run(args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every,
                   log_every=max(1, args.steps // 20),
                   chaos=chaos, fleet=fleet)
    dt = time.time() - t0
    hist = out["history"]
    print(f"[train] done in {dt:.1f}s; loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f}")
    if out["skipped_steps"] or out["rollbacks"]:
        print(f"[train] resilience: {out['skipped_steps']} skipped, "
              f"{out['rollbacks']} rollbacks, data cursor +{out['data_offset']}")
    if out.get("replans"):
        print(f"[train] fleet: {out['replans']} re-plan(s), final plan "
              f"dp={out['plan'].dp} pp={out['plan'].pp}")
    return out


if __name__ == "__main__":
    main()
