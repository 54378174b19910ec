"""Batched serving CLI: the static mode of ``repro.launch.serve`` over the
port's ``InferenceSession``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \
      --batch 4 --prompt-len 512 --gen 32 [--reduced] [--device cpu]

It runs on the card unless ``--device cpu`` is given.  The request-stream
mode comes with the continuous-batching scheduler's port.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sess = InferenceSession.from_recipe(args.arch, reduced=args.reduced,
                                        seed=0, device=args.device)
    return run_static(sess, args)


if __name__ == "__main__":
    main()
