"""The machinery of ``tests/test_torch_{hybrid_tp,xlstm_mesh,whisper_mesh}.py``:
a family's reduced config on gloo meshes of the CPU against the JAX
reference on one device, in f32.

A file lists its cases as :class:`Case` and calls :func:`run_worlds` from a
module fixture: the reference's initial states are written, one world of
``python -c`` processes is started per world size (file store under the
test's tmp dir; ``RANK`` from the environment; one torch thread a rank)
and each rank runs every case
of its world through the user's entry points while the parent computes the
reference's results.  Per case a rank writes (npz):

* the metrics of ``N_STEPS`` ``TrainSession`` steps at gas 2 from the
  reference's initial state (placed by ``checkpoint.elastic.reshard_state``),
  the first moment after the first step (0.1 times its gradient) and the
  train state after the last, both gathered to the reference's layout by
  ``elastic.host_snapshot`` (the sharded checkpoint), and whether that
  snapshot, placed again and gathered again, gives the same bits;
* ``evaluate`` of the trained state on a later batch;
* for a served case, ``InferenceSession.from_params`` of the initial
  weights on the mesh: ``prefill`` logits of the first batch and
  ``generate``'s greedy tokens.

:func:`check_step` and :func:`check_serving` hold them to the reference at
the tolerances of ``PERF.md`` §2.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.recipe import ParallelismConfig as JPlan
from repro.session.infer import InferenceSession as RefInference
from repro.session.train import TrainSession as RefTrainSession
from test_torch_moe import _flat, _train_cfgs
from test_torch_xlstm_train import GAS, _cfgs, _data, _steps

ROOT = Path(__file__).resolve().parents[1]
N_STEPS, NEW, PROMPT, EVAL_BATCH = 3, 6, 10, 7


@dataclasses.dataclass(frozen=True)
class Case:
    """One plan of a family: ``mesh`` the keywords of ``make_recipe_mesh``
    in a world of ``world`` ranks, ``plan`` those of ``ParallelismConfig``
    (gas 2 added), ``cfg`` the reduced config's overrides, ``seq`` the
    tokens a row where the case needs another count than its file's."""
    name: str
    world: int
    mesh: Tuple = ()
    plan: Tuple = ()
    cfg: Tuple = ()
    serve: bool = True
    seq: Optional[int] = None


def _extra(arch):
    """The batch's non-token inputs a prefill takes."""
    return ("frames",) if arch == "whisper_base" else ()


# the families whose reference is sensitive past its f32 rounding at these
# lengths: the hybrid's SSD chunk sums reach thousands over 300 positions,
# so one rounding of dt moves a decay by ~2e-4 relative
# (``tests/test_torch_hybrid.py``); its metrics and logits are held to their
# tolerance plus twice the reference's own change under a one-ulp nudge
NUDGED = ("hymba_15b",)
ULP = 2.0 ** -23


def _ref_session(arch, seq, cfg):
    jcfg, _ = _cfgs(arch, **dict(cfg))
    return RefTrainSession(jcfg, plan=JPlan(gas=GAS), seed=5, train_cfg=_train_cfgs()[0],
                           data_cfg=_data(seq)[0])


def _nudge(params, e=ULP):
    return dict(params, embed=params["embed"] * (1 + e))


def _nudged(arch, seq, cfg, e):
    """The reference's metrics of each step and its params after them, its
    embedding scaled by 1 + e."""
    ref = _ref_session(arch, seq, cfg)
    ref.state = dict(ref.state, params=_nudge(ref.state["params"], e))
    metrics = [{k: float(v) for k, v in ref.step(ref.batches(i)).items()}
               for i in range(N_STEPS)]
    return metrics, {k: v for k, v in _flat(ref.state).items() if k.startswith("params/")}


def _served(arch, seq, cfg, e=0.0):
    """The reference's prefill logits of the first batch and its greedy
    tokens from the initial weights (the embedding scaled by 1 + e)."""
    ref = _ref_session(arch, seq, cfg)
    inf = RefInference.from_params(ref.cfg, _nudge(ref.state["params"], e))
    b0 = ref.batches(0)
    prefill = np.asarray(inf.prefill(
        {k: jnp.asarray(b0[k]) for k in ("tokens",) + _extra(arch)}, last_only=False))
    return prefill, np.asarray(inf.generate(np.asarray(b0["tokens"])[:, :PROMPT], NEW))


@functools.lru_cache(maxsize=None)
def reference(arch, seq, cfg=(), serve=False):
    """The reference on one device (consensus off, as the cases' GAS
    path): ``N_STEPS`` steps (their metrics and states), ``evaluate`` of the
    trained state, and with ``serve`` the first batch's prefill logits and
    the greedy tokens of its first ``PROMPT`` positions, from the initial
    weights.  ``floor``: per step and metric (and ``"prefill"``) the
    reference's own change when its embedding is scaled by 1 ± 2^-23 (the
    larger of the two), and ``param_floor`` each parameter's after the
    steps (``NUDGED`` families; empty for the others).  The runs go in
    threads side by side."""
    nudges = (ULP, -ULP) if arch in NUDGED else ()
    with ThreadPoolExecutor() as ex:
        nudged = [ex.submit(_nudged, arch, seq, cfg, e) for e in nudges]
        served = [ex.submit(_served, arch, seq, cfg, e) for e in (0.0,) + nudges if serve]
        r = _steps(arch, seq, cfg, N_STEPS)
        out = SimpleNamespace(steps=r, floor={}, param_floor={},
                              xent=float(r.ref.evaluate(r.ref.batches(EVAL_BATCH))["xent"]))
        for f in nudged:
            metrics, params = f.result()
            for i, (mn, mr) in enumerate(zip(metrics, r.metrics)):
                for k, v in mr.items():
                    out.floor[i, k] = max(out.floor.get((i, k), 0.0), abs(mn[k] - v))
            for k, v in params.items():
                d = np.abs(v - r.states[-1][k])
                out.param_floor[k] = np.maximum(out.param_floor.get(k, d), d)
        if serve:
            out.prefill, out.tokens = served[0].result()
            for f in served[1:]:
                out.floor["prefill"] = max(out.floor.get("prefill", 0.0),
                                           float(np.abs(f.result()[0] - out.prefill).max()))
    return out


def run_worlds(module, arch, seq, cases, tmp):
    """Every case's initial state written, every world's ranks started, the
    references computed while they run → {case name: the reference}."""
    for cfg, s in {(c.cfg, c.seq or seq) for c in cases}:
        np.savez(tmp / f"init{_tag(cfg, s)}.npz", **_steps(arch, s, cfg, N_STEPS).initial)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = {world: [subprocess.Popen([sys.executable, "-c",
                                       f"import {module} as t; t.rank_main({world}, "
                                       f"{str(tmp)!r})"], env={**env, "RANK": str(r)},
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for r in range(world)]
             for world in sorted({c.world for c in cases})}
    keys = {(c.seq or seq, c.cfg, c.serve) for c in cases}
    with ThreadPoolExecutor() as ex:
        done = dict(zip(keys, ex.map(lambda k: reference(arch, *k), keys)))
    refs = {c.name: done[c.seq or seq, c.cfg, c.serve] for c in cases}
    for world, ps in procs.items():
        logs = []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=400)[0])
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                raise
        bad = [r for r, p in enumerate(ps) if p.returncode]
        assert not bad, "\n".join(f"world {world} rank {r}:\n{logs[r][-4000:]}" for r in bad)
    return refs


def _tag(cfg, seq):
    return "".join(f"-{k}{v}" for k, v in cfg) + f"-seq{seq}"


def rank_main(arch, seq, cases, world, tmp):
    """One rank of a world: every case of the world, results under ``tmp``."""
    import torch.distributed as dist
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
                            world_size=world)
    for c in cases:
        if c.world == world:
            np.savez(tmp / f"{c.name}_r{rank}.npz", **_rank_case(arch, seq, c, tmp))
    dist.barrier()
    dist.destroy_process_group()


def _rank_case(arch, seq, case, tmp) -> Dict[str, np.ndarray]:
    from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy
    from repro_torch.checkpoint.elastic import host_snapshot, reshard_state
    from repro_torch.core.recipe import ParallelismConfig
    from repro_torch.launch.mesh import make_recipe_mesh
    from repro_torch.session import InferenceSession, TrainSession
    seq = case.seq or seq
    _, cfg = _cfgs(arch, **dict(case.cfg))
    mesh = make_recipe_mesh(device_type="cpu", **dict(case.mesh))
    plan = ParallelismConfig(gas=GAS, **dict(case.plan))
    initial = dict(np.load(tmp / f"init{_tag(case.cfg, seq)}.npz"))
    sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu",
                        train_cfg=_train_cfgs(consensus=False)[1], data_cfg=_data(seq)[1])
    sess.state = reshard_state(state_from_numpy(initial), plan, mesh=mesh, cfg=cfg)
    out = {}
    for i in range(N_STEPS):
        for k, v in sess.step(sess.batches(i)).items():
            out[f"step{i}/{k}"] = np.asarray(float(v))
        if i == 0:
            out.update({"first/" + k: v for k, v in host_snapshot(sess.state, plan, mesh=mesh,
                                                                   cfg=cfg)
                        if k.startswith("opt/m/")})
    snap = dict(host_snapshot(sess.state, plan, mesh=mesh, cfg=cfg))
    out.update({"state/" + k: v for k, v in snap.items()})
    again = dict(host_snapshot(reshard_state(state_from_numpy(snap), plan, mesh=mesh, cfg=cfg),
                               plan, mesh=mesh, cfg=cfg))
    out["roundtrip_bitwise"] = np.array(again.keys() == snap.keys() and all(
        np.array_equal(again[k], v) for k, v in snap.items()))
    out["eval/xent"] = np.asarray(float(sess.evaluate(sess.batches(EVAL_BATCH))["xent"]))
    if case.serve:
        inf = InferenceSession.from_params(cfg, params_from_numpy(
            {k[len("params/"):]: v for k, v in initial.items() if k.startswith("params/")}),
            plan=plan, mesh=mesh, device="cpu")
        b0 = sess.batches(0)
        out["prefill"] = inf.prefill({k: b0[k] for k in ("tokens",) + _extra(arch)},
                                     last_only=False).numpy()
        out["tokens"] = inf.generate(b0["tokens"][:, :PROMPT], NEW).numpy()
    return out


def got(tmp, case, rank=0):
    return dict(np.load(tmp / f"{case.name}_r{rank}.npz"))


def check_step(tmp, case, ref):
    """``N_STEPS`` steps: loss, xent, grad_norm, lr and the gate 1e-5
    relative (plus twice the reference's floor) on every step, the same
    loss on every rank; the first
    moment after the first step (0.1 g) 5e-4 as a gradient; every parameter
    after the last 1e-5 (for a ``NUDGED`` family plus twice the reference's
    own change; at most 1e-4 of the entries, at Adam's noise floor, 2·lr);
    the gathered checkpoint has the reference's leaves and
    shapes and round-trips bitwise; eval xent 1e-5."""
    g = got(tmp, case)
    r = ref.steps
    for i, mr in enumerate(r.metrics):
        for k in ("loss", "xent", "grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(float(g[f"step{i}/{k}"]), mr[k], rtol=1e-5,
                                       atol=1e-7 + 2 * ref.floor.get((i, k), 0.0),
                                       err_msg=f"step {i} {k}")
    for rank in range(1, case.world):
        other = got(tmp, case, rank)
        assert all(float(other[f"step{i}/loss"]) == float(g[f"step{i}/loss"])
                   for i in range(N_STEPS))
    first = r.states[0]
    for k, w in first.items():
        if k.startswith("opt/m/"):
            np.testing.assert_allclose(g["first/" + k] / 0.1, w / 0.1, atol=5e-4, rtol=5e-4,
                                       err_msg=k)
    state = {k[len("state/"):]: v for k, v in g.items() if k.startswith("state/")}
    want = r.states[-1]
    assert set(state) == set(want)
    assert all(state[k].shape == np.shape(w) for k, w in want.items())
    # each entry 1e-5 (plus twice the nudged reference's own change); an
    # entry at Adam's noise floor (lr·m/(√v + eps) with |g| near eps, ~1e-9)
    # can move by up to 2·lr as the sums over ranks reorder it: such entries
    # are held to 2·lr and must stay rare
    lr, floor, total = r.metrics[-1]["lr"], 0, 0
    for k, w in want.items():
        if k.startswith("params/"):
            d = np.abs(state[k] - w)
            ok = d <= 1e-5 + 1e-5 * np.abs(w) + 2 * ref.param_floor.get(k, 0.0)
            assert (ok | (d <= 2 * lr)).all(), k
            floor += int((~ok).sum())
            total += d.size
    assert floor <= 1e-4 * total, (floor, total)
    assert bool(g["roundtrip_bitwise"])
    np.testing.assert_allclose(float(g["eval/xent"]), ref.xent, rtol=1e-5)


def check_serving(tmp, case, ref, *, logits_tol=2e-5):
    """Prefill logits (``logits_tol``, plus twice the reference's floor)
    and greedy tokens (exact) on every rank."""
    for rank in range(case.world):
        g = got(tmp, case, rank)
        np.testing.assert_allclose(g["prefill"], ref.prefill, rtol=logits_tol,
                                   atol=logits_tol + 2 * ref.floor.get("prefill", 0.0))
        np.testing.assert_array_equal(g["tokens"], ref.tokens)
