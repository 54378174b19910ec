"""The port's prefill and ``EvalSession`` against the reference, on the CPU.

Mirrors ``tests/test_eval_session.py`` on bridged weights (the reference's
``lm_init`` parameters, carried over by path): ``InferenceSession.prefill``
against the reference's ``prefill`` for both values of ``last_only``
(within 2e-5, the ``(B, 1, V)`` shape included); ``evaluate`` (metrics
within 1e-5 relative, ``n_tokens`` exact with and without ``loss_mask``);
``perplexity`` against the reference's on the same batches, ragged ones
included, and its ``ValueError`` when no token bears loss;
``from_train_session`` shares the training weights' storage.
"""

import math
import pkgutil

import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.session import EvalSession as RefEvalSession
from repro.session import InferenceSession as RefInferenceSession
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.session import EvalSession, InferenceSession, TrainSession

# GQA + tied head (granite); MHA, D 96 and an untied head (phi3); a window
# (h2o: 32 in its reduced form)
ARCHS = ["granite_3_2b", "phi3_mini_38b", "h2o_danube_3_4b"]


def _flat(params):
    return params_from_numpy({k: np.asarray(v) for k, v in store._flatten(params)})


def _batch(cfg, B, S, seed, mask_frac=None):
    """tokens, labels and optionally a loss_mask whose first ``mask_frac``
    of the B·S positions bear loss, as the reference test makes them."""
    rs = np.random.RandomState(seed)
    b = {"tokens": rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
         "labels": rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if mask_frac is not None:
        mask = np.zeros((B * S,), np.float32)
        mask[:int(B * S * mask_frac)] = 1.0
        b["loss_mask"] = mask.reshape(B, S)
    return b


@pytest.fixture(scope="module")
def evals():
    """(reference EvalSession, port EvalSession on the CPU, same weights)."""
    ref = RefEvalSession.from_recipe("granite_3_2b", reduced=True, seed=3)
    port = EvalSession(get_config("granite_3_2b").reduced(), params=_flat(ref.params),
                       device="cpu")
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("last_only", [True, False])
def test_prefill_matches_reference(arch, last_only):
    ref = RefInferenceSession.from_recipe(arch, reduced=True, seed=1)
    port = InferenceSession.from_params(get_config(arch).reduced(), _flat(ref.params),
                                        device="cpu")
    B, S, V = 2, 40, ref.cfg.vocab_size          # 40 > h2o's reduced window of 32
    batch = {"tokens": _batch(ref.cfg, B, S, seed=2)["tokens"]}
    want = np.asarray(ref.prefill(batch, last_only=last_only))
    got = port.prefill(batch, last_only=last_only)
    assert got.dtype == torch.float32 and got.grad_fn is None
    assert tuple(got.shape) == want.shape == ((B, 1, V) if last_only else (B, S, V))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    if not last_only:       # the last position of the full prefill is last_only's
        np.testing.assert_allclose(got[:, -1:].numpy(),
                                   port.prefill(batch, last_only=True).numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mask_frac", [None, 1.0, 0.25])
def test_evaluate_matches_reference(evals, mask_frac):
    ref, port = evals
    b = _batch(port.cfg, 2, 32, seed=4, mask_frac=mask_frac)
    want, got = ref.evaluate(b), port.evaluate(b)
    assert set(got) == set(want) == {"xent", "aux", "n_tokens"}
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7)
    assert got["n_tokens"] == want["n_tokens"] == 2 * 32 * (mask_frac or 1.0)


def test_evaluate_counts_tokens_of_a_tensor_mask(evals):
    _, port = evals
    b = _batch(port.cfg, 2, 32, seed=5, mask_frac=0.5)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    assert port.evaluate(tb)["n_tokens"] == port.evaluate(b)["n_tokens"] == 32.0


def test_perplexity_matches_reference_token_weighted(evals):
    """Ragged batches (different shapes, one mostly masked): the port's
    sweep equals the reference's and a hand-rolled Σ xent·n / Σ n."""
    ref, port = evals
    batches = [_batch(port.cfg, 2, 32, seed=6, mask_frac=1.0),
               _batch(port.cfg, 2, 32, seed=7, mask_frac=0.25),
               _batch(port.cfg, 1, 24, seed=8)]
    want = ref.perplexity(batches)
    got = port.perplexity(batches)
    per = [port.evaluate(b) for b in batches]
    hand = sum(float(m["xent"]) * m["n_tokens"] for m in per) / sum(m["n_tokens"] for m in per)
    assert got["n_batches"] == want["n_batches"] == 3
    assert got["n_tokens"] == want["n_tokens"] == 64 + 16 + 24
    np.testing.assert_allclose(got["xent"], want["xent"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-4)
    assert got["xent"] == pytest.approx(hand, rel=1e-6)
    assert got["perplexity"] == pytest.approx(math.exp(got["xent"]))


def test_zero_token_sweep_raises(evals):
    _, port = evals
    with pytest.raises(ValueError, match="no loss-bearing tokens"):
        port.perplexity([_batch(port.cfg, 2, 32, seed=9, mask_frac=0.0)])
    with pytest.raises(ValueError, match="no loss-bearing tokens"):
        port.perplexity([])


def test_from_train_session_shares_params():
    sess = TrainSession.from_recipe("granite_3_2b", reduced=True, device="cpu")
    ev = EvalSession.from_train_session(sess)
    pairs = list(zip(tree_leaves(sess.state["params"]), tree_leaves(ev.params)))
    assert pairs and all(pa == pb and a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                         for (pa, a), (pb, b) in pairs)       # no copy, no cast
    assert ev.device == sess.device and ev.plan is sess.plan
    b = _batch(sess.cfg, 2, 32, seed=10)
    assert float(ev.evaluate(b)["xent"]) == float(sess.evaluate(b)["xent"])


def test_fresh_weights_follow_the_seed_in_the_compute_dtype():
    a = EvalSession.from_recipe("granite_3_2b", reduced=True, seed=5, device="cpu")
    b = EvalSession.from_recipe("granite_3_2b", reduced=True, seed=5, device="cpu")
    c = EvalSession.from_recipe("granite_3_2b", reduced=True, seed=6, device="cpu")
    la, lb, lc = (tree_leaves(s.params) for s in (a, b, c))
    assert all(x.dtype == a.cfg.compute_dtype for _, x in la)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lc))


def test_eval_session_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EvalSession.from_recipe("granite_3_2b", reduced=True)


def test_standalone_walk_covers_evalsess():
    """``test_torch_serving.py``'s check that the port imports without JAX
    walks these packages; ``session/evalsess.py`` is among them."""
    import repro_torch
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert "repro_torch.session.evalsess" in mods
