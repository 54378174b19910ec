"""Serving CLI over the port's ``InferenceSession``, as
``repro.launch.serve``.  Static batch:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \
      --batch 4 --prompt-len 512 --gen 32 [--reduced] [--device cpu]

Request-stream mode (continuous batching on contiguous slots, or with
``--paged`` on the block-paged KV pool with prefix sharing):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \
      --stream 16 --slots 8 [--paged] [--page-size 16] [--reduced] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.session import InferenceSession


def run_static(sess: InferenceSession, args):
    cfg = sess.cfg
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    toks = sess.generate(prompts, args.gen)
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    dt = time.perf_counter() - t0
    n_new = toks.shape[1] - args.prompt_len
    print(f"[serve] {cfg.name} on {sess.device}: generated {n_new} tokens × batch "
          f"{args.batch} in {dt:.2f}s ({args.batch * n_new / dt:.1f} tok/s)")
    print("[serve] sample:", toks[0, args.prompt_len:args.prompt_len + 16].cpu().numpy())
    return toks


def run_stream(sess: InferenceSession, args):
    """A mixed-length synthetic request stream through the
    continuous-batching scheduler: prompt lengths cycle through two buckets
    and decode budgets vary widely (the static batch's worst case), drawn
    as the reference draws them."""
    cfg = sess.cfg
    rng = np.random.RandomState(0)
    plen_buckets = sorted({max(4, args.prompt_len // 2), args.prompt_len})
    prompts, gens = [], []
    for r in range(args.stream):
        plen = plen_buckets[r % len(plen_buckets)]
        prompts.append(rng.randint(0, cfg.vocab_size, size=plen).astype(np.int32))
        gens.append(int(rng.randint(1, args.gen + 1)))
    t0 = time.perf_counter()
    outs, stats = sess.serve(prompts, gens, n_slots=args.slots, paged=args.paged,
                             page_size=args.page_size)
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {sess.device}: {stats.requests} requests "
          f"({sum(gens)} tokens) through {args.slots} slots in {dt:.2f}s")
    print(f"[serve] {stats}")
    if args.paged:
        print(f"[serve] pool: {stats.pool_pages} pages of {stats.page_size} "
              f"(occupancy {stats.pool_occupancy:.2f}), prefix hits "
              f"{stats.prefix_hits} (rate {stats.prefix_hit_rate:.2f})")
    for p, o in zip(prompts[:4], outs[:4]):
        print(f"[serve] P={len(p)} → {o[len(p):len(p) + 8]}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="serve N mixed-length requests via continuous batching")
    ap.add_argument("--slots", type=int, default=4,
                    help="scheduler slot count (stream mode)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the block-paged KV pool with copy-on-write "
                         "prefix sharing (stream mode)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sess = InferenceSession.from_recipe(args.arch, reduced=args.reduced,
                                        seed=0, device=args.device)
    if args.stream:
        return run_stream(sess, args)
    return run_static(sess, args)


if __name__ == "__main__":
    main()
