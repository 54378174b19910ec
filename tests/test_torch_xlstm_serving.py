"""The port's xLSTM family (``xlstm_125m``) served, against the JAX
reference, on the CPU, in f32 at ``reduced()`` (4 layers, sLSTM at {1, 3}),
the reference's weights bridged to the port:

* ``prefill`` logits at S 300 (three mLSTM chunks, the last ragged);
* the decode step run over 300 positions from fresh states: every
  position's logits within the reference's 5e-5 of the chunked forward's
  (``tests/test_models.py`` holds its own decode to that), and the
  cache-populating prefill (the decode scan) then decode steps: logits
  2e-5 and every token equal to the reference's;
* greedy ``generate`` tokens identical;
* the contiguous slot stream (no bucketing, each admission a decode scan):
  tokens and every ``ServingStats`` field equal to the reference's on one
  fake clock, every request's tokens equal to its own ``generate``, with
  requests admitted into slots others have just left;
* a retired slot's state reset to a fresh one's (``m`` -1e30), no kernel
  launched, ``paged=True`` refused, and the serve CLI at ``--reduced``.
"""

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
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import build
from repro_torch.models import api as tapi
from repro_torch.session import ContinuousBatchingScheduler, InferenceSession, RequestQueue
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat
from test_torch_moe_serving import _drive

ARCH = "xlstm_125m"


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(1))
    return (RefInference.from_params(jcfg, jparams),
            InferenceSession.from_params(cfg, params_from_numpy(_flat(jparams)), device="cpu"))


def _prompts(seed, B, P):
    return np.random.RandomState(seed).randint(0, 256, (B, P)).astype(np.int32)


def test_prefill_logits_match_reference():
    ref, port = _pair()
    b = {"tokens": _prompts(0, 2, 300)}
    for last_only in (False, True):
        want = np.asarray(ref.prefill({"tokens": jnp.asarray(b["tokens"])},
                                      last_only=last_only))
        got = port.prefill(b, last_only=last_only).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_decode_matches_forward_at_every_position():
    """300 decode steps from fresh states against the chunked forward over
    the same 300 tokens: every position's logits within 5e-5."""
    _, port = _pair()
    tokens = torch.from_numpy(_prompts(5, 2, 300))
    full = port.prefill({"tokens": tokens}, last_only=False)
    caches = port.init_cache(2, 300)
    with torch.inference_mode():
        steps = []
        for t in range(300):
            logits, caches = tapi.decode_step(port.cfg, port.params, tokens[:, t], t, caches)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=5e-5,
                               rtol=5e-5)


def test_cache_prefill_then_decode_tokens_exact():
    """The decode-scan prefill over 40 positions then 12 decode steps:
    the prefill's logits 2e-5 and every token equal to the reference's; the
    states' leaves and shapes are the reference's."""
    ref, port = _pair()
    P, L = 40, 52
    b = {"tokens": _prompts(1, 3, P)}
    jcaches = ref.init_cache(3, L)
    jl, jcaches = ref.prefill_cache_step(ref.params, {"tokens": jnp.asarray(b["tokens"])},
                                         jcaches)
    caches = port.init_cache(3, L)
    assert sorted(caches) == sorted(jcaches) == ["pre"]
    for c, jc in zip(caches["pre"], jcaches["pre"]):
        assert {k: tuple(v.shape) for k, v in c.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
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
    for c, jc in zip(caches["pre"], jcaches["pre"]):
        for k in c:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), atol=1e-4, rtol=1e-4)


def test_generate_tokens_equal_reference_and_launch_no_kernel():
    ref, port = _pair()
    prompts = _prompts(2, 4, 36)
    build.launch_counts.clear()
    got = port.generate(prompts, 10).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.generate(prompts, 10)))
    assert sum(build.launch_counts.values()) == 0


def test_stream_equals_reference_and_generate_with_slot_reuse():
    """Seven requests through 2 slots: five of them enter a slot that a
    finished request has just left.  Tokens and ``ServingStats`` equal the
    reference's scheduler; each request's tokens equal its own
    ``generate`` (no state crossed requests); ``paged=True`` raises in
    both packages."""
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


def test_retired_slot_resets_to_a_fresh_state():
    """``zero_slot`` sets a slot's states to a fresh cache's (``m``
    -1e30, the rest 0) and leaves the other slot alone; ``insert_slot``
    replaces every leaf."""
    _, port = _pair()
    caches = port.init_cache(2, 16)
    with torch.inference_mode():
        port.serve_step(port.params, torch.tensor([3, 4], dtype=torch.int32), 0, caches)
        before = {p: x[0].clone() for p, x in tree_leaves(caches)}
        port.zero_slot(caches, 1)
        fresh = port.init_cache(1, 16)
        for (p, x), (_, f) in zip(tree_leaves(caches), tree_leaves(fresh)):
            torch.testing.assert_close(x[1:], f, rtol=0, atol=0, msg=str(p))
            torch.testing.assert_close(x[0], before[p], rtol=0, atol=0)
        assert float(caches["pre"][1]["m"][1].max()) == np.float32(-1e30)
        port.serve_step(port.params, torch.tensor([7], dtype=torch.int32), 0, fresh)
        port.insert_slot(caches, fresh, 0)
    for (_, x), (_, f) in zip(tree_leaves(caches), tree_leaves(fresh)):
        torch.testing.assert_close(x[:1], f, rtol=0, atol=0)
    stepfn.cache_zero_slot(port.cfg, caches, 0)
    assert float(caches["pre"][0]["C"][0].abs().sum()) == 0.0


def test_serve_cli_reduced_on_the_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "40",
                       "--gen", "4", "--device", "cpu"])
    assert tuple(toks.shape) == (2, 44)
    serve.main(["--arch", ARCH, "--reduced", "--stream", "4", "--slots", "2",
                "--prompt-len", "10", "--gen", "3", "--device", "cpu"])
    assert "tok/s" in capsys.readouterr().out
