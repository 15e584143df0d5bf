"""Serving CLI: continuous-batching greedy decode of an
architecture's smoke config on random weights drawn from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models.transformer import init_params
from repro_torch.serve.llm import Request, ServeEngine
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the CUDA device unless given")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).smoke()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    eng = ServeEngine(params, cfg, batch_slots=args.slots,
                      max_len=args.max_len, eos_id=-1)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, 4 + i % 5
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    eng.run_to_completion()
    dt = time.time() - t0
    total = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.1f}s "
          f"({total/dt:.1f} tok/s, {args.slots} slots, {dev})")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.output}")


if __name__ == "__main__":
    main()
