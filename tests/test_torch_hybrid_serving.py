"""The port's hybrid family (``hymba_15b``) served, against the JAX
reference, on the CPU, in f32 at the 5-layer cut of ``test_torch_hybrid``
(global layers {0, 2, 4}, a window of 32 on 1 and 3), the reference's
weights bridged to the port:

* ``prefill`` logits (2e-5), and the cache-populating prefill (the decode
  scan: each prompt position a decode step, as the reference's
  ``prefill_cache``) then decode: logits 2e-5 and every token equal, with
  prompts past the window, so the SWA layers' rings (32 slots) wrap while
  the global layers' hold ``max_len``;
* greedy ``generate`` tokens identical;
* the contiguous slot stream (no bucketing: a family without padded
  prefill): tokens and every ``ServingStats`` field equal to the
  reference's on one fake clock, every request's tokens equal to its own
  ``generate``, with requests admitted into slots others have just left
  (a retired slot's SSM state must not reach the next request);
* ``paged=True`` refused, and the serve CLI at ``--reduced``.
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
from repro_torch.core import stepfn
from repro_torch.session import ContinuousBatchingScheduler, InferenceSession, RequestQueue
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat
from test_torch_moe_serving import _drive

ARCH = "hymba_15b"
N_LAYERS = 5


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), n_layers=N_LAYERS)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=N_LAYERS)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(1))
    return (RefInference.from_params(jcfg, jparams),
            InferenceSession.from_params(cfg, params_from_numpy(_flat(jparams)), device="cpu"))


def _prompts(seed, B, P):
    return np.random.RandomState(seed).randint(0, 256, (B, P)).astype(np.int32)


def test_prefill_logits_match_reference():
    """Every position's logits and the last one's, over 44 positions (past
    the window of 32)."""
    ref, port = _pair()
    b = {"tokens": _prompts(0, 3, 44)}
    for last_only in (False, True):
        want = np.asarray(ref.prefill({"tokens": jnp.asarray(b["tokens"])},
                                      last_only=last_only))
        got = port.prefill(b, last_only=last_only).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cache_prefill_then_decode_tokens_exact():
    """The decode-scan prefill over 40 positions then 12 decode steps: the
    rings of the SWA layers are 32 slots, the global layers' 52; the
    prefill's logits 2e-5, every token equal."""
    ref, port = _pair()
    P, L = 40, 52
    b = {"tokens": _prompts(1, 3, P)}
    jcaches = ref.init_cache(3, L)
    jl, jcaches = ref.prefill_cache_step(ref.params, {"tokens": jnp.asarray(b["tokens"])},
                                         jcaches)
    caches = port.init_cache(3, L)
    sizes = [c["kv"]["k"].shape[1] for c in caches["blocks"]]
    assert sizes == [L, 32, L, 32, L]
    assert tuple(caches["blocks"][0]["ssm_h"].shape) == (3, 2, 8, 64)
    assert tuple(caches["blocks"][0]["conv"].shape) == (3, 3, 128)
    with torch.inference_mode():
        tl, caches = port.prefill_cache_step(port.params, {"tokens": torch.from_numpy(
            b["tokens"])}, caches)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    tok = tl.argmax(-1).to(torch.int32)
    for t in range(P, L):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jtok, jcaches = ref.serve_step(ref.params, jtok, jnp.int32(t), jcaches)
        with torch.inference_mode():
            tok, caches = port.serve_step(port.params, tok, t, caches)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for c, jc in zip(caches["blocks"], jcaches["hymba"]):
        np.testing.assert_allclose(c["ssm_h"].numpy(), np.asarray(jc["ssm_h"]), atol=1e-4,
                                   rtol=1e-4)


def test_generate_tokens_equal_reference():
    ref, port = _pair()
    prompts = _prompts(2, 4, 36)
    np.testing.assert_array_equal(port.generate(prompts, 10).numpy(),
                                  np.asarray(ref.generate(prompts, 10)))


def test_stream_equals_reference_and_generate_with_slot_reuse():
    """Seven requests through 2 slots: five of them enter a slot that a
    finished request has just left.  Tokens and ``ServingStats`` equal the
    reference's scheduler; each request's tokens equal its own
    ``generate`` (so no SSM state or conv buffer crossed requests);
    ``paged=True`` raises in both packages."""
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
    assert not port.family.supports_padded_prefill(port.cfg)
    with pytest.raises(ValueError, match="paged"):
        port.serve(prompts[:2], 2, paged=True)
    with pytest.raises(ValueError, match="paged"):
        ref.serve(prompts[:2], 2, paged=True)


def test_retired_slot_holds_no_state():
    """``zero_slot`` resets a slot's ring, SSM state and conv buffer, and
    ``insert_slot`` replaces all three."""
    _, port = _pair()
    caches = port.init_cache(2, 16)
    with torch.inference_mode():
        port.serve_step(port.params, torch.tensor([3, 4], dtype=torch.int32), 0, caches)
        for c in caches["blocks"]:
            assert float(c["ssm_h"].abs().sum()) > 0 and float(c["conv"].abs().sum()) > 0
        stepfn.cache_zero_slot(port.cfg, caches, 1)
        fresh = port.init_cache(1, 16)
        port.serve_step(port.params, torch.tensor([7], dtype=torch.int32), 0, fresh)
        port.insert_slot(caches, fresh, 0)
    for c, f in zip(caches["blocks"], fresh["blocks"]):
        assert float(c["ssm_h"][1].abs().sum()) == 0 and float(c["conv"][1].abs().sum()) == 0
        assert bool((c["kv"]["pos"][1] == -1).all())
        torch.testing.assert_close(c["ssm_h"][:1], f["ssm_h"], rtol=0, atol=0)
        torch.testing.assert_close(c["conv"][:1], f["conv"], rtol=0, atol=0)


def test_serve_cli_reduced_on_the_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "40",
                       "--gen", "4", "--device", "cpu"])
    assert tuple(toks.shape) == (2, 44)
    serve.main(["--arch", ARCH, "--reduced", "--stream", "4", "--slots", "2",
                "--prompt-len", "10", "--gen", "3", "--device", "cpu"])
    assert "tok/s" in capsys.readouterr().out
