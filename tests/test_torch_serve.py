"""The port's ``DecodeServer`` against the reference's, on the CPU.

Both serve the reference demo's traffic (6 requests, prompts of 3-8
tokens, 24 new tokens, 4 slots) at the yi-6b smoke config in f32, with the
reference's ``init_params`` weights carried across.  They are driven in
lockstep: every admission and decode step's logits must agree within
``LM_F32_TOL`` (``tests/_torch_ref.py``), and the greedy tokens must be
equal.  Where a greedy token differs, the reference's top two logits at
that step must lie within the tolerance of each other (a near tie that the
summation order decides), and the comparison stops there, because the two
servers then decode different sequences.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import LM_F32_TOL, x64_off
from repro.configs import registry as ref_registry
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve

REQUESTS, MAX_NEW, SLOTS = 6, 24, 4


def _capture(server, log):
    """Record the logits of every decode call of ``server``."""
    inner = server._decode

    def wrapped(*args):
        out = inner(*args)
        logits = out[0] if isinstance(out, tuple) else out
        log.append(np.asarray(logits.detach() if hasattr(logits, "detach") else logits,
                              np.float32))
        return out

    server._decode = wrapped


@pytest.mark.parametrize("arch", ["yi-6b"])
def test_decode_server_matches_reference(arch):
    with x64_off():
        rcfg = dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                                   dtype=jnp.float32)
        rparams = ref_T.init_params(jax.random.PRNGKey(0), rcfg)
        ref = ref_serve.DecodeServer(rcfg, rparams, slots=SLOTS, max_len=MAX_NEW + 16)
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), dtype=torch.float32)
    params = convert.transformer_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, "cpu")
    port = serve.DecodeServer(cfg, params, slots=SLOTS, max_len=MAX_NEW + 16, device="cpu")
    ref_logits, port_logits = [], []
    _capture(ref, ref_logits)
    _capture(port, port_logits)

    prompts = serve.demo_prompts(REQUESTS, cfg.vocab)
    pending = list(prompts)
    finished, compared = 0, 0
    with x64_off():
        while finished < REQUESTS:
            while pending:
                a = ref.admit(pending[0][0], pending[0][1])
                assert port.admit(pending[0][0], pending[0][1]) == a
                if not a:
                    break
                pending.pop(0)
            r_done, p_done = ref.step(), port.step()
            assert len(ref_logits) == len(port_logits)
            for i in range(compared, len(ref_logits)):
                np.testing.assert_allclose(port_logits[i], ref_logits[i], atol=LM_F32_TOL,
                                           rtol=LM_F32_TOL, err_msg=f"decode call {i}")
            compared = len(ref_logits)
            for s, r in ref.slot_req.items():
                got, want = port.outputs[r], ref.outputs[r]
                if got != want:
                    t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
                    top2 = np.sort(ref_logits[-1][s])[-2:]
                    gap = float(top2[1] - top2[0])
                    assert gap <= 2 * (LM_F32_TOL + LM_F32_TOL * abs(float(top2[1]))), (
                        f"request {r} token {t}: {got[t]} vs {want[t]}, reference "
                        f"top-2 gap {gap}")
                    return
            assert r_done == p_done
            finished += len(r_done)
    assert sorted(port.outputs) == list(range(REQUESTS))
    assert port.outputs == ref.outputs
    assert all(len(v) > 0 for v in port.outputs.values())


def test_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "yi-6b", "--requests", "3", "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 requests" in out and "request 2 done" in out


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    cfg = registry.get_config("yi-6b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.DecodeServer(cfg, {}, device=None)
