"""The port's MoE family served, against the JAX reference, on the CPU.

Reduced ``olmoe_1b_7b`` and ``deepseek_moe_16b`` in f32, the reference's
seeded weights bridged to the port:

* greedy tokens of ``generate`` at B 8, whose decode-scan prefill and
  decode steps route the batch as one group with (token, slot)s dropped,
  and its prefill logits (2e-5);
* the contiguous scheduler on a family without padded prefill (each
  admission a decode scan, each decode step routing every slot alone):
  tokens exact and every ``ServingStats`` field equal on one fake clock;
  ``paged=True`` raises in both packages;
* the slot step: each row what a one-row decode gives it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.session.infer import InferenceSession as RefInference
from repro.session.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro.session.scheduler import RequestQueue as RefQueue
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import api as tapi
from repro_torch.models import moe
from repro_torch.session import ContinuousBatchingScheduler, InferenceSession, RequestQueue
from test_torch_moe import ARCHS, _flat

_REF = {}


def _pair(arch):
    if arch not in _REF:
        _REF[arch] = RefInference.from_recipe(arch, reduced=True, seed=0)
    ref = _REF[arch]
    return ref, InferenceSession.from_params(get_config(arch).reduced(),
                                             params_from_numpy(_flat(ref.params)),
                                             device="cpu")


class FakeClock:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return float(self.n)


def _drive(scheduler_cls, queue_cls, sess, prompts, gens, **kw):
    clock = FakeClock()
    queue = queue_cls(clock=clock)
    rids = [queue.submit(p, m) for p, m in zip(prompts, gens)]
    outputs, stats = scheduler_cls(sess, **kw).run(queue, clock=clock)
    return [outputs[r] for r in rids], dataclasses.asdict(stats)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_reference_with_drops(arch, monkeypatch):
    """B 8: the decode-scan prefill and every decode step route the batch
    as one group (C 5 of 16 slots at E 4, k 2), and some slots drop; the
    greedy tokens equal the reference's."""
    ref, port = _pair(arch)
    prompts = np.random.RandomState(2).randint(0, 256, (8, 12)).astype(np.int32)
    seen = []
    real = moe._slots

    def counting(*a):
        row, lands = real(*a)
        seen.append(int((~lands).sum()))
        return row, lands

    monkeypatch.setattr(moe, "_slots", counting)
    got = port.generate(prompts, 8).numpy()
    want = np.asarray(ref.generate(prompts, 8))
    np.testing.assert_array_equal(got, want)
    assert sum(seen) > 0
    np.testing.assert_allclose(port.prefill({"tokens": prompts}, last_only=False).numpy(),
                               np.asarray(ref.prefill({"tokens": prompts}, last_only=False)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_tokens_and_stats_equal_reference(arch):
    """The contiguous scheduler on a family without padded prefill: no
    bucketing, each admission a decode scan over its prompt (prompts of
    one length together), each decode step routing every slot alone (the
    reference vmaps a one-token decode): tokens exact, every
    ``ServingStats`` field equal on one fake clock.  ``paged=True`` raises
    in both."""
    ref, port = _pair(arch)
    rs = np.random.RandomState(4)
    lens = [5, 9, 5, 9, 9, 5, 9]
    prompts = [rs.randint(1, 256, size=n).astype(np.int32) for n in lens]
    gens = [6, 3, 8, 4, 5, 7, 3]
    kw = dict(n_slots=3, max_len=20)
    want = _drive(RefScheduler, RefQueue, ref, prompts, gens, **kw)
    got = _drive(ContinuousBatchingScheduler, RequestQueue, port, prompts, gens, **kw)
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(b, a)
    assert got[1] == want[1]
    assert not port.family.supports_padded_prefill(port.cfg)
    with pytest.raises(ValueError, match="paged"):
        port.serve(prompts[:2], 2, paged=True)
    with pytest.raises(ValueError, match="paged"):
        ref.serve(prompts[:2], 2, paged=True)


def test_slot_step_routes_each_slot_alone():
    """The slot step gives each row what a one-row decode gives it: with one
    token a group nothing drops, whatever the other slots hold."""
    _, port = _pair("olmoe_1b_7b")
    cfg = port.cfg
    rs = np.random.RandomState(5)
    caches = port.init_cache(8, 16)
    toks = torch.from_numpy(rs.randint(0, 256, 8).astype(np.int32))
    ts = torch.zeros(8, dtype=torch.int32)
    with torch.no_grad():
        got, _ = port.slot_step(port.params, toks, ts, caches)
        for i in range(8):
            one = port.init_cache(1, 16)
            logits, _ = tapi.decode_step(cfg, port.params, toks[i:i + 1], 0, one)
            assert int(got[i]) == int(logits.argmax(-1)[0])
