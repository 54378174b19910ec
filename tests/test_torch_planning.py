"""The port's planning models (``repro_torch.core.{systems, memory,
cost_model, scaling, autotune}``) against the reference's, on the CPU.

Two kinds of test:

* mirrors of the reference's 20 planning tests, on the port's functions:
  the 16 of ``tests/test_paper_claims.py`` (Table 1, Figs 1-3 and 5, Table
  2's search, the advisor), the two cost tests of ``tests/test_pipeline.py``
  and the two memory properties of ``tests/test_properties.py``, the latter
  as fixed parametrised grids, not Hypothesis draws;
* parity, held with ``==`` (the port keeps the reference's arithmetic in
  Python floats and numpy, in the same order): every ``StepCost`` field over
  the seven ported configs x a plan grid x three systems, the block-skip
  fraction, the memory model, the scaling plans, the Bayesian search's
  whole trial list, and ``BENCH_scaling.json``'s four curves row for row.

The reference's TPU profile is rebuilt as a port ``System`` inside the
tests: the port itself carries no TPU figures.  Also here: the port's
refusal messages name the ROADMAP items they wait for.
"""

import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import autotune as ref_autotune
from repro.core import cost_model as ref_cost
from repro.core import memory as ref_memory
from repro.core import recipe as ref_recipe
from repro.core import scaling as ref_scaling
from repro.core import systems as ref_systems
from repro_torch.configs import PORTED, get_config
from repro_torch.core import autotune, cost_model, memory, scaling, systems
from repro_torch.core.autotune import SearchSpace, bayesian_search, best_so_far
from repro_torch.core.cost_model import estimate_step
from repro_torch.core.recipe import ParallelismConfig, RecipeAdvisor
from repro_torch.core.systems import SMNG_P2

ROOT = Path(__file__).resolve().parent.parent

# (port System, reference System) pairs: the paper's system, the
# reference's TPU profile rebuilt in the port's class, the port's card
SYSTEM_PAIRS = {
    "smng_p2": (systems.SMNG_P2, ref_systems.SMNG_P2),
    "ref_tpu": (systems.System(**dataclasses.asdict(ref_systems.TPU_V5E)),
                ref_systems.TPU_V5E),
    "h100_sxm": (systems.H100_SXM,
                 ref_systems.System(**dataclasses.asdict(systems.H100_SXM))),
}


# ===========================================================================
# mirrors of tests/test_paper_claims.py (C1-C6), on the port
# ===========================================================================

def test_table1_memory_exact():
    t = memory.table1()
    assert t["3.6B"]["params_GB"] == pytest.approx(21.6, rel=1e-6)
    assert t["3.6B"]["grads_GB"] == pytest.approx(7.2, rel=1e-6)
    assert t["3.6B"]["optimizer_GB"] == pytest.approx(28.8, rel=1e-6)
    assert t["3.6B"]["total_GB"] == pytest.approx(57.6, rel=1e-6)
    assert t["20B"]["total_GB"] == pytest.approx(320.0, rel=1e-6)
    assert t["175B"]["total_GB"] == pytest.approx(2800.0, rel=1e-6)


def test_fig1_tp_cliff():
    cfg = get_config("gpt_36b")
    tput = {}
    for tp in (4, 8, 16):
        plan = ParallelismConfig(tp=tp, pp=1, dp=1, mbs=2, gas=8)
        tput[tp] = estimate_step(cfg, plan, system=SMNG_P2).model_tflops_per_device
    assert tput[8] > 0.5 * tput[4]
    assert tput[16] < 0.6 * tput[8], f"no cliff: {tput}"


def test_fig2_microbatch_amortization():
    cfg = get_config("gpt_20b")
    tputs = [estimate_step(cfg, ParallelismConfig(tp=8, pp=8, dp=1, mbs=1, gas=g),
                           system=SMNG_P2).model_tflops_per_device
             for g in (8, 16, 32, 64, 128)]
    assert all(b >= a * 0.999 for a, b in zip(tputs, tputs[1:])), tputs
    assert tputs[-1] / tputs[-2] < tputs[1] / tputs[0]


def test_fig3_pp_at_fixed_m_decreases():
    cfg = get_config("gpt_20b")
    tputs = [estimate_step(cfg, ParallelismConfig(tp=8, pp=pp, dp=1, mbs=1, gas=32),
                           system=SMNG_P2).model_tflops_per_device
             for pp in (4, 8, 16)]
    assert tputs[0] > tputs[1] > tputs[2], tputs


def test_fig3_constant_pp_over_m_stable():
    cfg = get_config("gpt_20b")
    tputs = [estimate_step(cfg, ParallelismConfig(tp=8, pp=pp, dp=1, mbs=1, gas=4 * pp),
                           system=SMNG_P2).model_tflops_per_device
             for pp in (4, 8, 16)]
    spread = (max(tputs) - min(tputs)) / max(tputs)
    assert spread < 0.15, f"PP/M-constant should be ~stable: {tputs}"


def _objective_175b(get_cfg, Plan, estimate, system):
    """``tests/test_paper_claims.py``'s Table 2 objective, for either
    package's functions."""
    cfg = get_cfg("gpt_175b")

    def objective(c):
        plan = Plan(tp=c["tp"], pp=c["pp"], dp=1, mbs=c["mbs"], gas=c["gas"], zero_stage=1)
        if cfg.n_layers % plan.pp:
            return 0.0, True
        cost = estimate(cfg, plan, system=system)
        if not cost.feasible:
            return 0.0, True
        return cost.model_tflops_per_device, False
    return objective


PORT_OBJECTIVE = _objective_175b(get_config, ParallelismConfig, estimate_step, SMNG_P2)


def test_table2_bo_finds_paper_like_config():
    trials, best = bayesian_search(PORT_OBJECTIVE, SearchSpace(), budget=40, n_init=8, seed=0)
    assert best.config["tp"] <= 8
    assert best.config["gas"] == 100
    plan = ParallelismConfig(pp=best.config["pp"], gas=best.config["gas"])
    assert plan.bubble_fraction < 0.20
    frac = best.value * 1e12 / SMNG_P2.peak_flops
    assert 0.06 < frac < 0.14, f"best {best.value} TF/s = {frac:.1%} of peak"
    traj = best_so_far(trials)
    assert traj[-1] >= traj[7]


def test_bo_penalizes_infeasible():
    trials, best = bayesian_search(PORT_OBJECTIVE, SearchSpace(), budget=25, n_init=6, seed=3)
    fails = [t for t in trials if t.failed]
    assert all(t.value == -1.0 for t in fails)
    assert not best.failed


def _scaling(kind: str, factor: int) -> float:
    cfg = get_config("gpt_175b")
    base_plan = ParallelismConfig(tp=8, pp=16, dp=1, mbs=3, gas=100, zero_stage=1)
    base = estimate_step(cfg, base_plan, system=SMNG_P2)
    plan = (scaling.weak_plan(base_plan, factor) if kind == "weak"
            else scaling.strong_plan(base_plan, factor))
    scaled = estimate_step(cfg, plan, system=SMNG_P2)
    return scaled.model_tflops_per_device / base.model_tflops_per_device


def test_fig5_weak_scaling_band():
    eff = _scaling("weak", 8)
    assert 0.85 <= eff <= 1.0, f"weak scaling eff {eff:.1%} (paper ~93%)"


def test_fig5_strong_scaling_band():
    eff = _scaling("strong", 8)
    assert 0.70 <= eff <= 0.95, f"strong scaling eff {eff:.1%} (paper ~82%)"
    assert eff < _scaling("weak", 8), "strong must trail weak (paper Fig 5)"


def _recipe_curve(kind: str, **plan_kw):
    cfg = get_config("gpt_175b")
    # gas=96 (not 100): the interleaved rotation requires gas % pp == 0
    base = ParallelismConfig(tp=8, pp=16, dp=1, mbs=3, gas=96, zero_stage=1, **plan_kw)
    return scaling.scaling_curve(cfg, base, kind=kind, system=SMNG_P2, factors=(1, 2, 4, 8))


def test_fig5_recipe_point_weak_93pct():
    curve = _recipe_curve("weak", vpp=3, overlap_zero=True)
    assert curve[0]["efficiency"] == 1.0
    assert curve[-1]["devices"] == 1024
    assert curve[-1]["efficiency"] >= 0.90, \
        f"weak x8 eff {curve[-1]['efficiency']:.1%} (paper: 93%)"


def test_fig5_recipe_point_strong_82pct():
    curve = _recipe_curve("strong", vpp=3, overlap_zero=True)
    assert curve[-1]["efficiency"] >= 0.80, \
        f"strong x8 eff {curve[-1]['efficiency']:.1%} (paper: 82%)"
    assert 0.85 <= curve[-1]["tokens_per_step"] / curve[0]["tokens_per_step"] <= 1.05
    assert curve[-1]["step_time_s"] < curve[0]["step_time_s"]


def test_fig5_interleaving_beats_plain_strong():
    plain = _recipe_curve("strong", vpp=1)[-1]
    inter = _recipe_curve("strong", vpp=3, overlap_zero=True)[-1]
    assert plain["bubble"] > inter["bubble"]
    assert plain["efficiency"] < 0.80 < inter["efficiency"]


def test_strong_plan_refuses_draining_the_pipeline():
    base = ParallelismConfig(tp=8, pp=16, dp=1, mbs=3, gas=96)
    with pytest.raises(ValueError, match="fill"):
        scaling.strong_plan(base, 32)   # mbs 3→1, gas 96/(32/3)≈9 < pp=16
    ok = scaling.strong_plan(base, 8)   # mbs 3→1, gas 96/(8/3)=36 — legal
    assert ok.gas == 36 and ok.mbs == 1 and ok.dp == 8
    vbase = ParallelismConfig(tp=8, pp=4, dp=1, mbs=1, gas=24, vpp=2)
    assert scaling.strong_plan(vbase, 2).gas == 12
    vbase2 = ParallelismConfig(tp=8, pp=4, dp=1, mbs=1, gas=36, vpp=2)
    assert scaling.strong_plan(vbase2, 2).gas == 16  # 18 → trimmed to 16


def test_scaling_curve_throughput_from_step_time():
    cfg = get_config("gpt_175b")
    base = ParallelismConfig(tp=8, pp=16, dp=1, mbs=3, gas=96, zero_stage=1)
    row = scaling.scaling_curve(cfg, base, kind="weak", system=SMNG_P2, factors=(1,))[0]
    want = row["tokens_per_step"] / row["step_time_s"] / row["devices"]
    assert row["per_device_throughput"] == pytest.approx(want)


def _bench_curves():
    """``benchmarks/run.py:scaling_bench``'s four curves and summary,
    computed with the port's functions (nothing is written)."""
    cfg = get_config("gpt_175b")
    plain = ParallelismConfig(tp=8, pp=16, dp=1, mbs=3, gas=96, zero_stage=1)
    vpp = RecipeAdvisor.suggest_vpp(cfg.n_layers, plain.pp, plain.gas)
    inter = dataclasses.replace(plain, vpp=vpp, overlap_zero=True)
    curves = {f"{label}_{kind}": scaling.scaling_curve(cfg, base, kind=kind, system=SMNG_P2,
                                                       factors=(1, 2, 4, 8))
              for label, base in (("plain", plain), ("interleaved", inter))
              for kind in ("weak", "strong")}
    return {
        "model": cfg.name, "system": SMNG_P2.name,
        "base": {"tp": plain.tp, "pp": plain.pp, "mbs": plain.mbs, "gas": plain.gas,
                 "zero_stage": plain.zero_stage},
        "interleaved": {"vpp": inter.vpp, "overlap_zero": inter.overlap_zero},
        "curves": curves,
        "weak_eff_x8": round(curves["interleaved_weak"][-1]["efficiency"], 4),
        "strong_eff_x8": round(curves["interleaved_strong"][-1]["efficiency"], 4),
    }


def test_bench_scaling_artifact_when_present():
    """The port's own sweep meets the bands the reference holds
    ``BENCH_scaling.json`` to (the file is compared row by row below)."""
    bench = _bench_curves()
    assert bench["weak_eff_x8"] >= 0.90
    assert bench["strong_eff_x8"] >= 0.80
    assert len(bench["curves"]["interleaved_weak"]) == 4


def test_advisor_flags_cross_node_tp():
    adv = RecipeAdvisor(SMNG_P2)
    assert "tp" in adv.check(ParallelismConfig(tp=16))
    assert "tp" not in adv.check(ParallelismConfig(tp=8))
    assert "bubble" in adv.check(ParallelismConfig(pp=16, gas=16))
    p1 = ParallelismConfig(pp=8, gas=8, vpp=1)
    p2 = ParallelismConfig(pp=8, gas=8, vpp=2)
    assert p1.bubble_fraction == pytest.approx(7 / 15)
    assert p2.bubble_fraction == pytest.approx(7 / 23)
    assert p2.bubble_fraction == pytest.approx(
        ParallelismConfig(pp=8, gas=16, vpp=1).bubble_fraction)


# --- mirrors of tests/test_pipeline.py:179-204 --------------------------------

def test_estimate_step_interleaving_tradeoff():
    cfg = get_config("gpt_175b")
    plain = ParallelismConfig(tp=8, pp=16, mbs=3, gas=16, zero_stage=1)
    inter = ParallelismConfig(tp=8, pp=16, mbs=3, gas=16, zero_stage=1, vpp=3)
    a, b = estimate_step(cfg, plain, system=SMNG_P2), estimate_step(cfg, inter, system=SMNG_P2)
    assert b.bubble < a.bubble
    assert b.t_step < a.t_step
    assert b.t_pp > a.t_pp


def test_overlap_zero_hides_dp_time():
    cfg = get_config("gpt_175b")
    kw = dict(tp=8, pp=16, dp=8, mbs=3, gas=16, zero_stage=1)
    plain = estimate_step(cfg, ParallelismConfig(**kw), system=SMNG_P2)
    over = estimate_step(cfg, ParallelismConfig(**kw, overlap_zero=True), system=SMNG_P2)
    assert over.t_overlap > 0.0
    assert over.t_dp_exposed <= plain.t_dp_exposed
    assert over.t_step <= plain.t_step


# --- mirrors of tests/test_properties.py:64-84, as fixed grids ----------------

@pytest.mark.parametrize("n", [10**6, 3_600_000_007, 20 * 10**9, 123_456_789_012, 10**12])
def test_memory_model_16_bytes_per_param(n):
    mb = memory.model_state_bytes(n)
    assert mb.total == 16.0 * n
    assert mb.params == 6.0 * n


@pytest.mark.parametrize("tp,zero", list(itertools.product([1, 2, 4, 8, 16], [1, 2, 3])))
def test_per_device_memory_shrinks_with_parallelism(tp, zero):
    cfg = get_config("granite_3_2b")
    base = memory.per_device_bytes(cfg, dp=1, tp=1, pp=1, zero_stage=zero)
    for pp, dp in itertools.product([1, 2, 4], [1, 4, 16]):
        if cfg.n_layers % pp:
            continue
        shard = memory.per_device_bytes(cfg, dp=dp, tp=tp, pp=pp, zero_stage=zero)
        assert shard["params"] <= base["params"] + 1
        assert shard["optimizer"] <= base["optimizer"] + 1


# ===========================================================================
# parity with the reference, held with ==
# ===========================================================================

def test_systems_match_the_reference():
    port_fields = [(f.name, f.default) for f in dataclasses.fields(systems.System)]
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref_systems.System)]
    assert port_fields == ref_fields
    assert dataclasses.asdict(systems.SMNG_P2) == dataclasses.asdict(ref_systems.SMNG_P2)
    assert not hasattr(systems, "TPU_V5E")
    assert set(systems.SYSTEMS) == {"h100_sxm", "smng_p2"}
    for port, ref in SYSTEM_PAIRS.values():
        for group, crosses in itertools.product((1, 4, 8, 16, 64, 256, 512), (False, True)):
            assert port.domain_bw(group, crosses_pod=crosses) == ref.domain_bw(
                group, crosses_pod=crosses)


def _plan_grid():
    """tp x pp x remat x vpp crossed, two draws each (numpy seed 0) of the
    other axes: dp/pods, mbs, gas, ZeRO stage, overlap_zero,
    sequence_parallel, and estimate_step's seq, flash_backward and
    avg_docs_per_seq.  144 plans."""
    rng = np.random.default_rng(0)
    grid = []
    for tp, pp, remat, vpp in itertools.product((1, 4, 8, 16), (1, 4, 16),
                                                ("none", "dots", "full"), (1, 3)):
        for _ in range(2):
            dp, pods = [(1, 1), (2, 1), (8, 1), (16, 1), (4, 2), (8, 4)][rng.integers(6)]
            plan = dict(tp=tp, pp=pp, dp=dp, pods=pods, remat_policy=remat, vpp=vpp,
                        mbs=int(rng.choice([1, 2, 3, 8])),
                        gas=int(rng.choice([1, 4, 16, 48, 96, 100])),
                        zero_stage=int(rng.integers(1, 4)),
                        overlap_zero=bool(rng.integers(2)),
                        sequence_parallel=bool(rng.integers(2)))
            est = dict(seq=int(rng.choice([512, 2048, 4608])),
                       flash_backward=bool(rng.integers(2)),
                       avg_docs_per_seq=float(rng.choice([1.0, 2.5, 8.0])))
            grid.append((plan, est))
    return grid


PLAN_GRID = _plan_grid()


@pytest.mark.parametrize("system", sorted(SYSTEM_PAIRS))
@pytest.mark.parametrize("arch", PORTED)
def test_estimate_step_parity(arch, system):
    """Every StepCost field, for the whole plan grid, equals the reference's."""
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    port_sys, ref_sys = SYSTEM_PAIRS[system]
    assert len(PLAN_GRID) == 144
    for plan_kw, est_kw in PLAN_GRID:
        got = estimate_step(cfg, ParallelismConfig(**plan_kw), system=port_sys, **est_kw)
        want = ref_cost.estimate_step(ref_cfg, ref_recipe.ParallelismConfig(**plan_kw),
                                      system=ref_sys, **est_kw)
        assert got.as_dict() == want.as_dict(), (plan_kw, est_kw)
        assert cost_model.model_flops_per_token(cfg, est_kw["seq"]) == \
            ref_cost.model_flops_per_token(ref_cfg, est_kw["seq"])
    assert cost_model.active_params(cfg) == ref_cost.active_params(ref_cfg)
    assert cost_model.FLASH_BWD_ATTN_MULT == ref_cost.FLASH_BWD_ATTN_MULT


def test_estimate_step_stage_remat_raises_keyerror_in_both():
    """The reference's remat multipliers have no "stage" key; the port keeps
    that, so the two agree on every input."""
    cfg, ref_cfg = get_config("granite_3_2b"), ref_configs.get_config("granite_3_2b")
    with pytest.raises(KeyError, match="stage"):
        ref_cost.estimate_step(ref_cfg, ref_recipe.ParallelismConfig(remat_policy="stage"))
    with pytest.raises(KeyError, match="stage"):
        estimate_step(cfg, ParallelismConfig(remat_policy="stage"))
    # the memory model takes "stage" through its no-remat formula, in both
    got = memory.activation_bytes_per_layer(cfg, 2, 1024, remat="stage")
    assert got == ref_memory.activation_bytes_per_layer(ref_cfg, 2, 1024, remat="stage")
    assert got == memory.activation_bytes_per_layer(cfg, 2, 1024, remat="none")


def _packed_segments(seed, B=3, S=1024):
    """Packed rows of documents of random lengths (numpy seed), as ids."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, doc = 0, 1
        while pos < S:
            n = int(rng.integers(16, 400))
            seg[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 256), (False, None)])
def test_flash_block_skip_fraction_parity(bq, bk, causal, window):
    for seed in range(3):
        seg = _packed_segments(seed)
        got = cost_model.flash_block_skip_fraction(seg, bq=bq, bk=bk, causal=causal,
                                                   window=window)
        want = ref_cost.flash_block_skip_fraction(seg, bq=bq, bk=bk, causal=causal,
                                                  window=window)
        assert got == want and 0.0 <= got < 1.0
    one = _packed_segments(7, B=1)[0]             # a 1-D row, as the reference takes it
    assert cost_model.flash_block_skip_fraction(one, bq=bq, bk=bk) == \
        ref_cost.flash_block_skip_fraction(one, bq=bq, bk=bk)


def test_memory_model_parity():
    assert memory.table1() == ref_memory.table1()
    for n in (1, 3_600_000_000, 175 * 10**9):
        assert dataclasses.asdict(memory.model_state_bytes(n)) == dataclasses.asdict(
            ref_memory.model_state_bytes(n))
    kws = [dict(dp=dp, tp=tp, pp=pp, pods=pods, mbs=mbs, gas=gas, seq=seq,
                zero_stage=zero, remat=remat)
           for dp, tp, pp, pods, mbs, gas, seq, zero, remat in itertools.product(
               (1, 8), (1, 4), (1, 4), (1, 2), (1, 3), (1, 8), (1024, 4608), (1, 2, 3),
               ("none", "dots", "full", "stage"))]
    for arch in PORTED:
        cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
        for kw in kws:
            assert memory.per_device_bytes(cfg, **kw) == ref_memory.per_device_bytes(
                ref_cfg, **kw), (arch, kw)


def test_scaling_plans_parity():
    bases = [dict(tp=8, pp=16, dp=1, mbs=3, gas=96), dict(tp=8, pp=16, mbs=3, gas=100),
             dict(tp=8, pp=4, mbs=1, gas=36, vpp=2), dict(tp=4, pp=1, dp=2, mbs=8, gas=8),
             dict(tp=8, pp=16, mbs=3, gas=96, vpp=3, overlap_zero=True)]
    for kw in bases:
        base, ref_base = ParallelismConfig(**kw), ref_recipe.ParallelismConfig(**kw)
        for f in (1, 2, 3, 4, 8, 32):
            got = dataclasses.asdict(scaling.weak_plan(base, f))
            assert got == dataclasses.asdict(ref_scaling.weak_plan(ref_base, f))
            try:
                want = dataclasses.asdict(ref_scaling.strong_plan(ref_base, f))
            except ValueError as e:
                with pytest.raises(ValueError) as got_err:
                    scaling.strong_plan(base, f)
                assert str(got_err.value) == str(e)
            else:
                assert dataclasses.asdict(scaling.strong_plan(base, f)) == want
            assert scaling.tokens_per_step(base, 2048) == ref_scaling.tokens_per_step(
                ref_base, 2048)
    cfg, ref_cfg = get_config("gpt_20b"), ref_configs.get_config("gpt_20b")
    kw = dict(tp=8, pp=4, mbs=2, gas=32)
    base, ref_base = ParallelismConfig(**kw), ref_recipe.ParallelismConfig(**kw)
    port_sys, ref_sys = SYSTEM_PAIRS["h100_sxm"]

    def measured(plan):                                 # a stand-in clock
        return 1.0 + 0.01 * plan.dp
    for kind in ("weak", "strong"):
        assert scaling.scaling_curve(cfg, base, kind=kind, seq=1024, system=port_sys) == \
            ref_scaling.scaling_curve(ref_cfg, ref_base, kind=kind, seq=1024, system=ref_sys)
        assert scaling.scaling_curve(cfg, base, kind=kind, seq=1024, measure=measured) == \
            ref_scaling.scaling_curve(ref_cfg, ref_base, kind=kind, seq=1024, measure=measured)


@pytest.mark.parametrize("seed,budget,n_init", [(0, 40, 8), (3, 25, 6)])
def test_bayesian_search_trials_parity(seed, budget, n_init):
    """The whole trial list (configs, values, failures, in order) and the
    best trial equal the reference's, with Table 2's objective."""
    ref_objective = _objective_175b(ref_configs.get_config, ref_recipe.ParallelismConfig,
                                    ref_cost.estimate_step, ref_systems.SMNG_P2)
    trials, best = bayesian_search(PORT_OBJECTIVE, SearchSpace(), budget=budget,
                                   n_init=n_init, seed=seed)
    ref_trials, ref_best = ref_autotune.bayesian_search(
        ref_objective, ref_autotune.SearchSpace(), budget=budget, n_init=n_init, seed=seed)
    assert len(trials) == budget
    assert [dataclasses.asdict(t) for t in trials] == [dataclasses.asdict(t)
                                                       for t in ref_trials]
    assert dataclasses.asdict(best) == dataclasses.asdict(ref_best)
    assert np.array_equal(best_so_far(trials), ref_autotune.best_so_far(ref_trials),
                          equal_nan=True)
    assert autotune.PENALTY == ref_autotune.PENALTY


def test_gp_and_expected_improvement_parity():
    rng = np.random.default_rng(5)
    X, y, Xs = rng.random((12, 4)), rng.normal(size=12), rng.random((30, 4))
    gp, ref_gp = autotune.GP(), ref_autotune.GP()
    gp.fit(X, y)
    ref_gp.fit(X, y)
    (mu, sig), (ref_mu, ref_sig) = gp.predict(Xs), ref_gp.predict(Xs)
    assert np.array_equal(mu, ref_mu) and np.array_equal(sig, ref_sig)
    assert np.array_equal(autotune.expected_improvement(mu, sig, float(y.max())),
                          ref_autotune.expected_improvement(ref_mu, ref_sig, float(y.max())))
    space, ref_space = SearchSpace(), ref_autotune.SearchSpace()
    assert space.enumerate() == ref_space.enumerate()
    assert all(np.array_equal(space.encode(c), ref_space.encode(c))
               for c in space.enumerate())


def test_bench_scaling_curves_reproduced():
    """The port's sweep gives ``BENCH_scaling.json`` row for row, and its
    summary: interleaved weak x8 1.0 (overlapped ZeRO hides all DP time;
    the paper measured 93%), strong x8 0.8143."""
    bench = json.loads((ROOT / "BENCH_scaling.json").read_text())
    got = _bench_curves()
    assert got["interleaved"] == {"vpp": 3, "overlap_zero": True}
    for key in ("model", "system", "base", "interleaved", "weak_eff_x8", "strong_eff_x8"):
        assert got[key] == bench[key], key
    assert sorted(got["curves"]) == sorted(bench["curves"])
    for name, rows in bench["curves"].items():
        assert got["curves"][name] == rows, name
    assert got["weak_eff_x8"] == 1.0 and got["strong_eff_x8"] == 0.8143


# ===========================================================================
# the port's refusal messages name the ROADMAP items they wait for
# ===========================================================================

def test_refusal_messages_name_their_roadmap_items():
    from repro_torch.checkpoint import elastic
    from repro_torch.core import stepfn
    from repro_torch.models import registry, transformer
    families = "Queue 1, item 4: other families"
    parallel = "Queue 1, item 3: the parallel recipe over torch.distributed"
    cfg = get_config("granite_3_2b").reduced()
    with pytest.raises(NotImplementedError, match=families):
        dataclasses.replace(cfg, family="hybrid").n_params()
    with pytest.raises(NotImplementedError, match=families):
        registry.family_of(dataclasses.replace(cfg, family="vlm"))
    with pytest.raises(NotImplementedError, match=families):
        transformer.layer_plan(dataclasses.replace(cfg, family="ssm"))
    from types import SimpleNamespace
    from repro_torch.runtime.fleet import FleetController
    from repro_torch.runtime.train_loop import LoopConfig, run_training
    with pytest.raises(NotImplementedError, match=parallel):
        run_training({}, None, None, LoopConfig(total_steps=1), mesh=object(),
                     fleet=FleetController(2))
    with pytest.raises(NotImplementedError, match=parallel):
        stepfn.no_pipeline_mesh("the serve step", SimpleNamespace(shape={"pp": 2}))
    assert parallel in " ".join(elastic.__doc__.split())
