"""Fault tolerance: checkpoint/restart loop and straggler watch, the port of
``repro.train.fault``.

Failure is simulated in one process (an injected exception); the control
flow is the real thing: periodic async checkpoints, bounded retry with
restore-from-latest, step-time EMA straggler detection, and an elastic
re-placement of a restored tree onto a (smaller) mesh of ranks.  Each step
reads its loss to the host once, which also waits for the step's device
work (the reference's ``jax.block_until_ready``), so step times are device
times.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.models.common import tree_map, tree_zip_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.utils import host, resolve_device
from repro_torch.utils.device import DeviceLike


@dataclass
class FaultConfig:
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0    # step slower than factor x EMA -> flag
    ema_alpha: float = 0.2


@dataclass
class LoopStats:
    steps_done: int = 0
    restarts: int = 0
    stragglers: List[int] = field(default_factory=list)
    step_time_ema: float = 0.0


class FaultTolerantLoop:
    """Wraps a train step with checkpoint/restart + straggler detection."""

    def __init__(self, step_fn: Callable, cfg: FaultConfig):
        self.step_fn = step_fn
        self.cfg = cfg
        self.saver = ckpt.AsyncSaver()
        self.stats = LoopStats()

    def run(self, state, batches: Callable[[int], Any], num_steps: int,
            fail_at: Optional[Dict[int, BaseException]] = None):
        """batches(step) -> batch.  fail_at injects failures (tests)."""
        cfg = self.cfg
        step = 0
        # resume if a checkpoint exists
        last = ckpt.latest_step(cfg.ckpt_dir)
        if last is not None:
            state = ckpt.restore(state, cfg.ckpt_dir, last)
            step = last
        metrics = None
        while step < num_steps:
            t0 = time.perf_counter()
            try:
                if fail_at and step in fail_at:
                    raise fail_at.pop(step)
                state, metrics = self.step_fn(state, batches(step))
                host(metrics["loss"])
            except (RuntimeError, ValueError) as e:
                self.stats.restarts += 1
                if self.stats.restarts > cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded {cfg.max_restarts} restarts") from e
                last = ckpt.latest_step(cfg.ckpt_dir)
                if last is None:
                    # no checkpoint yet: restart from the initial state
                    step = 0
                    continue
                state = ckpt.restore(state, cfg.ckpt_dir, last)
                step = last
                continue
            dt = time.perf_counter() - t0
            ema = self.stats.step_time_ema
            ema = dt if ema == 0 else (cfg.ema_alpha * dt
                                       + (1 - cfg.ema_alpha) * ema)
            if (self.stats.step_time_ema > 0
                    and dt > cfg.straggler_factor * self.stats.step_time_ema):
                # on a real cluster: alert + preemptively re-shard around the
                # slow host / launch a backup replica of its work
                self.stats.stragglers.append(step)
            self.stats.step_time_ema = ema
            step += 1
            self.stats.steps_done += 1
            if step % cfg.ckpt_every == 0:
                self.saver.save(state, cfg.ckpt_dir, step)
        self.saver.wait()
        return state, metrics


def remesh(tree, device: DeviceLike = None, *, specs=None, mesh=None):
    """Elastic re-placement of a host tree (a restored checkpoint).

    With ``mesh`` (a rank mesh) and ``specs`` (a tree of spec tuples shaped
    like ``tree``, e.g. from ``launch.sharding.params_shardings`` for the
    new mesh): this rank's block of every tensor, on the mesh's device.
    Without: every tensor onto ``device`` (the card unless the caller names
    another)."""
    if mesh is None:
        dev = resolve_device(device)
        return tree_map(lambda x: x.to(dev), tree)
    from repro_torch.launch.mesh import require_rank_mesh
    from repro_torch.launch.sharding import local_block
    require_rank_mesh(mesh, "remesh")
    return tree_zip_map(
        lambda x, sp: local_block(x, sp, mesh).to(mesh.device), tree, specs)
