"""The port's encoder-decoder family (``whisper_base``) served, against the
JAX reference, on the CPU, in f32 at the cut of ``test_torch_whisper``
(2 + 2 layers, 50 frames), the reference's weights bridged to the port:

* ``prefill`` logits over given frames;
* the cache init (the encoder once, each layer's cross K/V) and decode
  steps over 30 positions: every position's logits within the reference's
  5e-5 of the forward's, and the tokens of the decode-scan prefill then
  decode equal to the reference's driven by hand over the same frames;
* greedy ``generate`` without frames (the family's stub zero frames, as
  the reference's ``generate``) tokens identical;
* the contiguous slot stream (its template from the stub frames, as the
  reference's scheduler builds it): tokens and every ``ServingStats``
  field equal to the reference's on one fake clock, every request's tokens
  equal to its own ``generate``, with slots reused;
* a retired slot reset and refilled, ``paged=True`` refused, and the serve
  CLI at ``--reduced``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.session.infer import InferenceSession as RefInference
from repro.session.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro.session.scheduler import RequestQueue as RefQueue
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import api as tapi
from repro_torch.session import ContinuousBatchingScheduler, InferenceSession, RequestQueue
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat
from test_torch_moe_serving import _drive

ARCH = "whisper_base"
FRAMES = 50


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), enc_frames=FRAMES)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), enc_frames=FRAMES)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(1))
    return (RefInference.from_params(jcfg, jparams),
            InferenceSession.from_params(cfg, params_from_numpy(_flat(jparams)), device="cpu"))


def _prompts(seed, B, P):
    return np.random.RandomState(seed).randint(0, 256, (B, P)).astype(np.int32)


def _frames(seed, B):
    return np.random.default_rng(seed).standard_normal((B, FRAMES, 64)).astype(np.float32)


def test_prefill_logits_match_reference():
    ref, port = _pair()
    b = {"tokens": _prompts(0, 3, 21), "frames": _frames(0, 3)}
    for last_only in (False, True):
        want = np.asarray(ref.prefill({k: jnp.asarray(v) for k, v in b.items()},
                                      last_only=last_only))
        got = port.prefill(b, last_only=last_only).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_decode_matches_forward_at_every_position():
    """30 decode steps from the cache init over given frames against the
    forward over the same tokens and frames: every position within 5e-5;
    the caches are a ring and the cross K/V a decoder layer."""
    _, port = _pair()
    tokens, frames = torch.from_numpy(_prompts(5, 2, 30)), _frames(5, 2)
    full = port.prefill({"tokens": tokens, "frames": frames}, last_only=False)
    caches = port.init_cache(2, 30, {"frames": frames})
    assert sorted(caches) == ["cross", "self"] and len(caches["cross"]) == 2
    assert tuple(caches["cross"][0]["k"].shape) == (2, FRAMES, 4, 16)
    assert tuple(caches["self"][0]["k"].shape) == (2, 30, 4, 16)
    with torch.inference_mode():
        steps = []
        for t in range(30):
            logits, caches = tapi.decode_step(port.cfg, port.params, tokens[:, t], t, caches)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=5e-5,
                               rtol=5e-5)


def test_generate_over_frames_equals_reference_driven_by_hand():
    """``generate(frames=)``: the reference's cache init over the same
    frames, its decode-scan prefill and serve steps give the same tokens."""
    ref, port = _pair()
    P, N, B = 12, 8, 3
    prompts, frames = _prompts(1, B, P), _frames(1, B)
    jc = ref.init_cache(B, P + N, {"frames": jnp.asarray(frames)})
    jl, jc = ref.prefill_cache_step(ref.params, {"tokens": jnp.asarray(prompts)}, jc)
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    want = [tok]
    for t in range(P, P + N - 1):
        tok, jc = ref.serve_step(ref.params, tok, jnp.int32(t), jc)
        want.append(tok)
    got = port.generate(prompts, N, frames=frames).numpy()
    np.testing.assert_array_equal(got[:, :P], prompts)
    np.testing.assert_array_equal(got[:, P:], np.stack([np.asarray(w) for w in want], 1))


def test_generate_tokens_equal_reference():
    ref, port = _pair()
    prompts = _prompts(2, 4, 16)
    np.testing.assert_array_equal(port.generate(prompts, 10).numpy(),
                                  np.asarray(ref.generate(prompts, 10)))


def test_stream_equals_reference_and_generate_with_slot_reuse():
    ref, port = _pair()
    rs = np.random.RandomState(4)
    lens = [6, 9, 6, 9, 9, 6, 9]
    prompts = [rs.randint(1, 256, size=n).astype(np.int32) for n in lens]
    gens = [5, 3, 7, 4, 5, 6, 3]
    kw = dict(n_slots=2, max_len=20)
    want = _drive(RefScheduler, RefQueue, ref, prompts, gens, **kw)
    got = _drive(ContinuousBatchingScheduler, RequestQueue, port, prompts, gens, **kw)
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(b, a)
    assert got[1] == want[1]
    for p, g, out in zip(prompts, gens, got[0]):
        np.testing.assert_array_equal(out, port.generate(p[None], g).numpy()[0])
    with pytest.raises(ValueError, match="paged"):
        port.serve(prompts[:2], 2, paged=True)
    with pytest.raises(ValueError, match="paged"):
        ref.serve(prompts[:2], 2, paged=True)


def test_retired_slot_is_reset_and_refilled():
    """``zero_slot`` empties a slot's ring and cross entries (positions -1,
    K/V 0) and leaves the other slot; ``insert_slot`` of a fresh cache
    restores the cross K/V."""
    _, port = _pair()
    caches = port.init_cache(2, 16, {"frames": _frames(3, 2)})
    with torch.inference_mode():
        port.serve_step(port.params, torch.tensor([3, 4], dtype=torch.int32), 0, caches)
        keep = {p: x[0].clone() for p, x in tree_leaves(caches)}
        port.zero_slot(caches, 1)
        for p, x in tree_leaves(caches):
            torch.testing.assert_close(x[0], keep[p], rtol=0, atol=0)
            assert bool((x[1] == (-1 if p[-1] == "pos" else 0)).all()), p
        fresh = port.init_cache(1, 16, {"frames": _frames(4, 1)})
        port.insert_slot(caches, fresh, 1)
    for (_, x), (_, f) in zip(tree_leaves(caches), tree_leaves(fresh)):
        torch.testing.assert_close(x[1:], f, rtol=0, atol=0)


def test_serve_cli_reduced_on_the_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "10",
                       "--gen", "4", "--device", "cpu"])
    assert tuple(toks.shape) == (2, 14)
    serve.main(["--arch", ARCH, "--reduced", "--stream", "4", "--slots", "2",
                "--prompt-len", "10", "--gen", "3", "--device", "cpu"])
    assert "tok/s" in capsys.readouterr().out
