"""The port's continuous-batching LLM engine == the reference's, token for
token, on the CPU.

Both engines serve the same requests on the same weights (the reference's,
carried by ``interop.transformer_params_from_arrays``): the script of
``tests/test_runtime.py::test_serve_engine_continuous_batching`` (tiny
config, 2 slots, requests longer than the slots can hold at once, the
same prompt twice), eviction by EOS and by ``max_len``, and a MoE config
whose idle slots share the experts' capacity with the busy ones.  Greedy
decoding compares argmaxes, so the outputs must be equal lists.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import repro.configs as r_configs
from repro.models import transformer as r_tfm
from repro.serve import llm as r_llm
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import serve as p_launch
from repro_torch.models import transformer as p_tfm
from repro_torch.serve import llm as p_llm
from repro_torch.utils import host

R_CFG = r_tfm.TransformerConfig(name="tiny", n_layers=2, d_model=32,
                                n_heads=4, n_kv_heads=2, d_ff=64, vocab=61,
                                head_dim=8, remat=False)
P_CFG = p_tfm.TransformerConfig(name="tiny", n_layers=2, d_model=32,
                                n_heads=4, n_kv_heads=2, d_ff=64, vocab=61,
                                head_dim=8, remat=False)


def weights(rcfg):
    pr = jax.jit(r_tfm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                        rcfg)
    arr = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), pr)
    return pr, interop.transformer_params_from_arrays(arr, device="cpu")


def runtime_script(vocab):
    """test_runtime's requests: prompts arange(3 + i) % vocab, 4 + i new
    tokens each, then the same 5-token prompt twice."""
    reqs = [(np.arange(3 + i, dtype=np.int32) % vocab, 4 + i)
            for i in range(5)]
    return reqs + [(np.arange(5, dtype=np.int32), 6)] * 2


def serve(pkg, params, cfg, script, slots, max_len, eos_id=-1):
    eng = pkg.ServeEngine(params, cfg, batch_slots=slots, max_len=max_len,
                          eos_id=eos_id)
    reqs = [pkg.Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(script)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return reqs


def outputs(reqs):
    return [(r.done, list(map(int, r.output))) for r in reqs]


@pytest.fixture(scope="module")
def tiny():
    return weights(R_CFG)


def test_serve_engine_continuous_batching(tiny):
    pr, pt = tiny
    script = runtime_script(R_CFG.vocab)
    want = serve(r_llm, pr, R_CFG, script, 2, 48)
    got = serve(p_llm, pt, P_CFG, script, 2, 48)
    assert outputs(got) == outputs(want)
    for r, (_, n) in zip(got, script):
        assert r.done and len(r.output) == n, r.uid
    assert got[-1].output == got[-2].output


def test_serve_engine_eos_and_max_len(tiny):
    """An EOS id that greedy decoding reaches ends requests early, and a
    ``max_len`` the longest requests outgrow ends them at ``max_len - 1``
    cached tokens: the same requests end at the same tokens."""
    pr, pt = tiny
    script = [(np.arange(3 + 2 * (i % 2), dtype=np.int32) * (i + 1) % 61,
               4 + i) for i in range(5)]
    first = outputs(serve(p_llm, pt, P_CFG, script, 2, 48))
    eos = first[4][1][2]                       # a token request 4 emits
    for eos_id, max_len in ((eos, 48), (-1, 10)):
        want = outputs(serve(r_llm, pr, R_CFG, script, 3, max_len, eos_id))
        got = outputs(serve(p_llm, pt, P_CFG, script, 3, max_len, eos_id))
        assert got == want, (eos_id, max_len)
        assert any(len(o) < n for (_, o), (_, n) in zip(got, script))


def test_serve_engine_moe_idle_slots():
    """qwen2-moe's smoke config: decode routes every slot's token, idle
    ones included, through experts of shared capacity, so the port must
    keep the reference's idle-slot state (tokens 0, lengths that run on)
    to decode the busy slots the same."""
    rcfg = r_configs.get_arch("qwen2-moe-a2.7b").smoke()
    pcfg = get_arch("qwen2-moe-a2.7b").smoke()
    pr, pt = weights(rcfg)
    script = [(np.arange(4, dtype=np.int32) * 7 % rcfg.vocab, 6),
              (np.arange(6, dtype=np.int32) * 5 % rcfg.vocab, 3),
              (np.arange(4, dtype=np.int32) * 3 % rcfg.vocab, 9)]
    want = serve(r_llm, pr, rcfg, script, 4, 24)
    got = serve(p_llm, pt, pcfg, script, 4, 24)
    assert outputs(got) == outputs(want)


def test_serve_engine_pulls_through_host(tiny):
    """Every device read is a counted ``host`` pull: one at each prefill
    (its first token), then per step one of the lengths and one of the
    next tokens."""
    _, pt = tiny
    eng = p_llm.ServeEngine(pt, P_CFG, batch_slots=2, max_len=32, eos_id=-1)
    eng.submit(p_llm.Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                             max_new_tokens=3))
    before = host.calls
    assert eng.step() == 1                     # prefill + first decode step
    assert host.calls - before == 2
    before = host.calls
    assert eng.step() == 1
    assert host.calls - before == 2
    assert eng.step() == 0 and eng.slot_req == [None, None]
    assert int(eng.cache["len"][0]) == 0


def test_launch_serve_cli():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        p_launch.main(["--arch", "gemma-2b", "--requests", "3", "--slots",
                       "2", "--max-new", "4", "--device", "cpu"])
    text = out.getvalue()
    assert "served 3 requests / 12 tokens" in text and "cpu" in text
    if not torch.cuda.is_available():       # no silent fallback to the host
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_launch.main(["--arch", "gemma-2b", "--requests", "1"])
