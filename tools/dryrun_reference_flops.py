"""The dry run's FLOP count of a small train cell beside the reference's.

    PYTHONPATH=src python3 tools/dryrun_reference_flops.py

Builds the same cell in both packages on a 1 x 1 mesh: starcoder2-3b's
smoke config at 2 layers, remat on, chunks of 8 keys, a batch of 4
sequences of 16 tokens (the cell of tests/test_torch_dryrun.py).  The
reference's is lowered and compiled for one CPU device with its scans
unrolled (``unroll_scans``, so XLA's ``cost_analysis`` counts every layer
and chunk) and read by its ``raw_costs``; the port's is counted on meta
tensors by ``roofline.analysis.raw_counts``.  XLA counts elementwise work
as FLOPs and the port's counter only matmuls, so the ratio is below 1.
Prints one JSON line.  Needs both packages: it runs on the CPU, where JAX
is installed, not on the card's machine.
"""
import dataclasses
import json

import jax

from repro.configs import get_arch as r_get_arch
from repro.configs.shapes import LMShape as RShape
from repro.launch import steps as r_steps
from repro.roofline.analysis import raw_costs
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import LMShape
from repro_torch.launch.mesh import make_meta_mesh
from repro_torch.launch.steps import lm_cell
from repro_torch.roofline.analysis import raw_counts

B, S, LAYERS, CHUNK = 4, 16, 2, 8


def main() -> None:
    over = {"n_layers": LAYERS, "remat": True, "attn_chunk": CHUNK}
    r_cfg = dataclasses.replace(r_get_arch("starcoder2-3b").smoke(),
                                unroll_scans=True, **over)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rc = r_steps.lm_cell("starcoder2-3b", RShape("train", S, B), "train",
                         mesh, cfg_override=r_cfg)
    with mesh:
        compiled = jax.jit(rc.fn, in_shardings=rc.in_shardings,
                           out_shardings=rc.out_shardings
                           ).lower(*rc.args).compile()
    r_flops, r_bytes, _ = raw_costs(compiled)
    p_cfg = dataclasses.replace(get_arch("starcoder2-3b").smoke(), **over)
    pmesh = make_meta_mesh((1, 1))
    pc = lm_cell("starcoder2-3b", LMShape("train", S, B), "train", pmesh,
                 p_cfg)
    p_flops, p_bytes, _ = raw_counts(pc, pmesh)
    print(json.dumps({
        "cell": f"starcoder2-3b smoke, {LAYERS} layers, remat, chunk "
                f"{CHUNK}, B {B}, S {S}, 1 x 1 mesh",
        "reference_raw_costs_flops": r_flops, "port_count_flops": p_flops,
        "port_over_reference": p_flops / r_flops,
        "reference_bytes_accessed": r_bytes, "port_bytes": p_bytes,
        "model_flops_per_step": pc.model_flops_per_step}))


if __name__ == "__main__":
    main()
