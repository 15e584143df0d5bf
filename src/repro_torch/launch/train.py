"""Training CLI, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --preset smoke --steps 20 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300

Presets: smoke (per-arch reduced config), 100m (~100M-param LM).  Weights
are drawn on the device from seed 0; batches are the seekable token stream
of ``data.tokens``.  Fault tolerance: checkpoints every --ckpt-every steps
to --ckpt-dir and resumes automatically from the latest one there.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import token_batch
from repro_torch.models.common import count_params
from repro_torch.models.transformer import (
    TransformerConfig, init_params, lm_loss,
)
from repro_torch.train import optimizer as opt
from repro_torch.train.fault import FaultConfig, FaultTolerantLoop
from repro_torch.train.trainer import init_train_state, make_train_step
from repro_torch.utils import host, resolve_device


def preset_100m() -> TransformerConfig:
    return TransformerConfig(
        name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab=32000, head_dim=64, remat=False)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None,
                    help="arch id (smoke config); omit with --preset 100m")
    ap.add_argument("--preset", type=str, default="smoke",
                    choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the CUDA device unless given")
    return ap.parse_args(argv)


def train(args: argparse.Namespace,
          fail_at: Optional[Dict[int, BaseException]] = None) -> dict:
    """Run the CLI's training loop; ``fail_at`` injects failures at steps
    (as ``FaultTolerantLoop.run``).  Returns the final state and loss, the
    loop's stats, the config, its parameter count and the run's seconds."""
    dev = resolve_device(args.device)
    if args.preset == "100m":
        cfg = preset_100m()
    else:
        cfg = get_arch(args.arch or "starcoder2-3b").smoke()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    n = count_params(params)
    print(f"arch={cfg.name} params={n/1e6:.1f}M batch={args.batch} "
          f"seq={args.seq} device={dev}")

    ocfg = opt.AdamWConfig(lr=args.lr,
                           warmup_steps=min(50, args.steps // 10 + 1),
                           total_steps=args.steps)
    step = make_train_step(lambda p, b: lm_loss(p, b[0], b[1], cfg), ocfg,
                           grad_accum=args.grad_accum)
    state = init_train_state(params, ocfg)

    # the counter-hash token stream is seekable, so batches are a pure
    # function of the step: what restart-from-checkpoint needs
    def batch_for(s):
        x, y = token_batch(s, args.batch, args.seq, cfg.vocab)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    loop = FaultTolerantLoop(step, FaultConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every))
    t0 = time.time()
    state, metrics = loop.run(state, batch_for, num_steps=args.steps,
                              fail_at=fail_at)
    dt = time.time() - t0
    loss = float(host(metrics["loss"]))
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({toks/dt:.0f} tok/s), final loss {loss:.4f}, "
          f"restarts={loop.stats.restarts}")
    return {"state": state, "loss": loss, "stats": loop.stats, "params": n,
            "seconds": dt, "config": cfg}


def main(argv=None) -> None:
    train(parse_args(argv))


if __name__ == "__main__":
    main()
