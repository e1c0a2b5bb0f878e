"""Parity of the port's dense LM serving path with the reference, on the CPU.

The reference's ``init_params`` weights for the yi-6b, codeqwen1.5-7b and
qwen3-8b smoke configs (GQA groups 2, 1 and 2, qwen3 with qk-norm) are
carried into the port by ``convert.transformer_params_from_reference``;
both packages then run ``prefill`` on the same tokens and 4
``decode_step``s on the same next tokens, and the logits and caches are
compared.  The layer ops are held against the reference one by one, and
token-by-token decode against full attention within the port.  Tolerances:
``LM_F32_TOL`` and ``BF16_ULP_TOL`` in ``tests/_torch_ref.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import BF16_ULP_TOL, LM_F32_TOL, x64_off
from repro.configs import registry as ref_registry
from repro.layers import common as ref_common
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.layers import common
from repro_torch.layers.attention import (AttentionConfig, attention_decode,
                                          attention_prefill, attention_train,
                                          init_attention)
from repro_torch.models import transformer as T

ARCHS = ["yi-6b", "codeqwen1.5-7b", "qwen3-8b"]
B, S, N_DECODE = 2, 128, 4


def _close(got, want, tol=LM_F32_TOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _reference_run(arch, backend, tokens, next_tokens):
    cfg = dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                              attention_backend=backend)
    with x64_off():
        params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
        logits, (ck, cv) = ref_T.prefill(params, cfg, jnp.asarray(tokens))
        cache = ref_T.init_cache(cfg, B, S + N_DECODE)
        cache = (cache[0].at[:, :, :S].set(ck), cache[1].at[:, :, :S].set(cv))
        steps = []
        for t in range(N_DECODE):
            pos = jnp.full((B,), S + t, jnp.int32)
            step_logits, cache = ref_T.decode_step(params, cfg, jnp.asarray(next_tokens[:, t]),
                                                   cache, pos)
            steps.append(np.asarray(step_logits))
    np_params = jax.tree.map(np.asarray, params)
    return np_params, np.asarray(logits), (np.asarray(ck), np.asarray(cv)), steps, cache


@pytest.mark.parametrize("backends", [("pallas", "pallas"), ("pallas", None),
                                      ("xla_chunked", "xla_chunked")],
                         ids=lambda b: f"ref-{b[0]}_port-{b[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, backends):
    ref_backend, port_backend = backends
    vocab = registry.get_config(arch, smoke=True).vocab
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    next_tokens = rng.integers(0, vocab, (B, N_DECODE)).astype(np.int32)
    np_params, r_logits, (r_ck, r_cv), r_steps, r_cache = _reference_run(
        arch, ref_backend, tokens, next_tokens)

    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              attention_backend=port_backend)
    params = convert.transformer_params_from_reference(np_params, cfg, "cpu")
    logits, (ck, cv) = T.prefill(params, cfg, torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, cfg.vocab)
    assert tuple(ck.shape) == (cfg.n_layers, B, S, cfg.n_kv, cfg.head_dim)
    _close(logits, r_logits, what="prefill logits")
    _close(ck, r_ck, what="prefill k cache")
    _close(cv, r_cv, what="prefill v cache")

    cache = T.init_cache(cfg, B, S + N_DECODE, device="cpu")
    cache[0][:, :, :S] = ck
    cache[1][:, :, :S] = cv
    for t in range(N_DECODE):
        pos = torch.full((B,), S + t, dtype=torch.long)
        step_logits, cache = T.decode_step(params, cfg,
                                           torch.from_numpy(next_tokens[:, t]).long(),
                                           cache, pos)
        _close(step_logits, r_steps[t], what=f"decode step {t} logits")
    _close(cache[0], r_cache[0], what="decoded k cache")
    _close(cache[1], r_cache[1], what="decoded v cache")


def test_params_round_trip_through_the_reference_tree():
    cfg = dataclasses.replace(registry.get_config("qwen3-8b", smoke=True),
                              dtype=torch.bfloat16)
    params = T.init_params(torch.Generator().manual_seed(3), cfg)
    back = convert.transformer_params_from_reference(
        convert.transformer_params_to_reference(params), cfg, "cpu")
    flat = lambda tree: [t for v in tree.values()  # noqa: E731
                         for t in (flat(v) if isinstance(v, dict) else [v])]
    for a, b in zip(flat(params), flat(back)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        bad = convert.transformer_params_to_reference(params)
        bad["head"] = bad["head"][:, :-1]
        convert.transformer_params_from_reference(bad, cfg, "cpu")


def test_registry_covers_the_ported_archs_only():
    for arch in ARCHS:
        full = registry.get_config(arch)
        ref = ref_registry.get_config(arch)
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv, full.d_ff, full.vocab,
                full.head_dim, full.qk_norm, full.rope_theta) == (
            ref.n_layers, ref.d_model, ref.n_heads, ref.n_kv, ref.d_ff, ref.vocab,
            ref.head_dim, ref.qk_norm, ref.rope_theta)
        assert full.n_params == ref.n_params
    with pytest.raises(KeyError, match="not ported"):
        registry.get_config("phi3.5-moe")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_kv", [1, 2, 4])
def test_attention_decode_matches_train(n_kv):
    """Token-by-token decode with a cache reproduces full attention (the
    reference's own check, tests/test_layers.py, at its tolerance 3e-5)."""
    cfg = AttentionConfig(d_model=32, n_heads=4, n_kv=n_kv, d_head=8, qk_norm=True)
    p = init_attention(torch.Generator().manual_seed(0), cfg, torch.float32)
    Bt, St = 2, 12
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(Bt, St, 32)).astype(np.float32))
    positions = torch.arange(St, dtype=torch.float32).expand(Bt, St)
    full = attention_train(p, cfg, x, positions)
    cache = (torch.zeros(Bt, St + 2, n_kv, 8), torch.zeros(Bt, St + 2, n_kv, 8))
    outs = []
    for t in range(St):
        o, cache = attention_decode(p, cfg, x[:, t:t + 1], cache,
                                    torch.full((Bt,), t, dtype=torch.long))
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               atol=3e-5, rtol=3e-5)
    out, (k, v) = attention_prefill(p, cfg, x, positions)
    assert tuple(k.shape) == (Bt, St, n_kv, 8)
    torch.testing.assert_close(out, full, atol=0, rtol=0)
    torch.testing.assert_close(cache[0][:, :St], k, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    with x64_off():
        want = ref_common.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype))
    got = common.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(g).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = LM_F32_TOL if dtype == "float32" else BF16_ULP_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d_head,theta", [(8, 10000.0), (128, 10000.0), (128, 1e6)])
def test_rope_matches_reference(d_head, theta):
    rng = np.random.default_rng(d_head)
    pos = np.broadcast_to(np.arange(4096, dtype=np.float32), (2, 4096))
    x = rng.normal(size=(2, 4096, 3, d_head)).astype(np.float32)
    with x64_off():
        cos_r, sin_r = ref_common.rope_angles(jnp.asarray(pos), d_head, theta)
        want = ref_common.apply_rope(jnp.asarray(x), cos_r, sin_r)
    cos, sin = common.rope_angles(torch.from_numpy(pos.copy()), d_head, theta)
    assert cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_r), atol=LM_F32_TOL, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_r), atol=LM_F32_TOL, rtol=0)
    got = common.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_F32_TOL,
                               rtol=LM_F32_TOL)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(5)
    x, w1, w3, w2 = (rng.normal(size=s).astype(np.float32) / 4
                     for s in ((2, 7, 64), (64, 96), (64, 96), (96, 64)))
    with x64_off():
        want = ref_common.swiglu(*(jnp.asarray(a) for a in (x, w1, w3, w2)))
    got = common.swiglu(*(torch.from_numpy(a) for a in (x, w1, w3, w2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_F32_TOL,
                               rtol=LM_F32_TOL)


def test_init_cache_defaults_to_the_card():
    cfg = registry.get_config("yi-6b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)


def test_moe_configs_are_refused():
    cfg = dataclasses.replace(registry.get_config("yi-6b", smoke=True), moe=object())
    with pytest.raises(NotImplementedError, match="MoE"):
        T.param_shapes(cfg)
