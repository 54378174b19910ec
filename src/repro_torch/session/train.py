"""``TrainSession``: a training lifecycle in one object, mirroring
``repro.session.train`` on one device.

It resolves the architecture config, applies the paper's recipe
(``ParallelismConfig`` + ``RecipeAdvisor`` checks), builds the train state
(fp32 master weights from ``seed``, AdamW moments), the single-device train
step and the deterministic data pipeline (batch = f(seed, step)), and steps
or runs the fault-tolerant checkpointed loop (``runtime.train_loop``).  The
session runs on the card unless the caller asks for the CPU; without CUDA
the default raises.

Typical use::

    sess = TrainSession.from_recipe("granite_3_2b", reduced=True, device="cpu",
                                    data_cfg=DataConfig(seq_len=64, global_batch=4))
    for _ in range(3):
        metrics = sess.step()
    # or: out = sess.run(50, ckpt_dir="/tmp/ckpt")   → {state, history, ...}
    inf = sess.to_inference()            # serve the trained weights

With ``plan=`` and ``mesh=`` (a ``launch.mesh.RecipeMesh``; every rank
builds the same session) the train state holds this rank's shards (tp's
slices, ZeRO's shards over the ``(pod, data)`` plane) and the step runs
over the mesh, every rank taking the same global batch and keeping its
replica's rows; at pp > 1 a rank holds its stage's layers and runs its
stage of the pipeline (``core.pipeline``).  ``to_inference`` gathers the
weights back to the reference layout (over the ``pp`` line too), and
``run(ckpt_dir=...)`` writes and restores the whole canonical state
(``checkpoint.elastic``).  Without a mesh pp > 1 runs every stage in this
process.  The fleet's re-plan runs on one device only.  The abstract
(dry-run) mode has no PyTorch counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core import sharding, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig, RecipeAdvisor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig, make_dataset
from repro_torch.data.pipeline import add_modality_inputs, estimate_mean_doc_len
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.train_loop import LoopConfig, run_training
from repro_torch.session.infer import (InferenceSession, resolve_config, resolve_device,
                                       to_device)


class TrainSession:
    def __init__(self, cfg: ModelConfig, *,
                 plan: Optional[ParallelismConfig] = None,
                 train_cfg: Optional[stepfn.TrainConfig] = None,
                 data_cfg: Optional[DataConfig] = None, mesh=None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 advisor: Optional[RecipeAdvisor] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan = plan if plan is not None else ParallelismConfig()
        self.train_cfg = train_cfg if train_cfg is not None else stepfn.TrainConfig()
        self.data_cfg = data_cfg
        self.mesh = mesh
        if self.plan.pp > 1:
            self.plan.validate(cfg.n_layers)   # pp·vpp layout + gas%pp rules
        # the paper's §7 checklist, evaluated once at composition time; the
        # data-aware packing hint is folded in when the dataset materializes
        self._advisor = advisor or RecipeAdvisor()
        self.advice: Dict[str, str] = self._advisor.check(self.plan, n_layers=cfg.n_layers)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.state = stepfn.init_state(cfg, self.plan, gen, self.train_cfg, mesh=mesh)
        self.train_step = stepfn.make_train_step(cfg, self.plan, self.train_cfg, mesh=mesh)
        self._eval_step = stepfn.make_eval_step(cfg, self.plan, mesh=mesh)
        self._dataset = None
        self._batch_cache: Dict[int, Any] = {}
        self._next_step = 0

    @classmethod
    def from_recipe(cls, arch: Union[str, ModelConfig], *, reduced: bool = False,
                    plan: Optional[ParallelismConfig] = None,
                    train_cfg: Optional[stepfn.TrainConfig] = None,
                    data_cfg: Optional[DataConfig] = None, mesh=None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda") -> "TrainSession":
        """Architecture name (or config) + recipe → a training session."""
        cfg = resolve_config(arch, reduced=reduced)
        return cls(cfg, plan=plan, train_cfg=train_cfg, data_cfg=data_cfg, mesh=mesh,
                   seed=seed, device=device)

    # ------------------------------------------------------------------
    # data pipeline (deterministic, resumable: batch = f(seed, step))
    # ------------------------------------------------------------------
    @property
    def dataset(self):
        if self._dataset is None:
            dc = self.data_cfg or DataConfig(seq_len=256, global_batch=32)
            self._dataset = make_dataset(dc, self.cfg)
            if not dc.pack_documents:
                # data-aware advice (never changes what the session trains on)
                sample = self._dataset.batch(0)
                self.advice.update(self._advisor.check(
                    self.plan, data_cfg=dc,
                    mean_doc_len=estimate_mean_doc_len(sample["tokens"], dc.eos_id)))
        return self._dataset

    def batches(self, step: int) -> Dict[str, np.ndarray]:
        """The numpy batch for ``step`` (one-slot cache)."""
        if step not in self._batch_cache:
            self._batch_cache.clear()
            b = self.dataset.batch(step)
            self._batch_cache[step] = add_modality_inputs(b, self.cfg, step,
                                                          self.dataset.cfg.seed)
        return self._batch_cache[step]

    def _device_step(self, train_step):
        """``train_step`` over host batches: each batch (the chaos harness's
        ``_chaos_grad_scale`` with it) moved to the device first."""
        return lambda state, batch: train_step(state, self._to_device(batch))

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return to_device(batch, self.device)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self, batch=None) -> Dict[str, torch.Tensor]:
        """One optimizer step; pulls the next pipeline batch when none is
        given.  Returns the metrics as 0-d tensors on the device."""
        if batch is None:
            batch = self.batches(self._next_step)
        self.state, metrics = self.train_step(self.state, self._to_device(batch))
        self._next_step += 1
        return metrics

    def run(self, steps: Optional[int] = None, *, ckpt_dir=None, ckpt_every: int = 50,
            log_every: Optional[int] = None, keep_ckpts: int = 3, async_ckpt: bool = True,
            fail_at_step: Optional[int] = None, chaos=None, fleet=None, ckpt_retry=None,
            tracker=None, log=print) -> Dict[str, Any]:
        """Fault-tolerant training to ``steps`` (default: the schedule length),
        as the reference's ``run``: restore → train → periodic atomic
        checkpoint → preemption handling, with the resilience policy from
        ``train_cfg.resilience`` (the config the step's skip gate was built
        with).  ``chaos`` is a ``runtime.chaos.FaultPlan``; ``fail_at_step``
        folds into it.  ``fleet`` is a ``runtime.fleet.FleetController``: on
        replica loss or a persistent straggler the loop re-plans through the
        ``make_step`` factory this session hands it, and the session's
        ``plan``/``train_step`` follow the final plan on the way out.

        While the loop runs it holds the only reference to the train state,
        so a restore does not keep the initial state alive beside it.  If the
        loop raises (a crash drill, a preemption), the session has no state
        left: resume through ``ckpt_dir`` in a fresh session, as after a real
        failure."""
        if self._next_step:
            raise RuntimeError(
                "run() restarts the data schedule at step 0 — don't mix manual "
                "step() with run() in one session; use a fresh session (resume "
                "happens via ckpt_dir) or keep stepping manually")
        if self.state is None:
            raise RuntimeError("this session's run() raised and its state is gone; "
                               "resume through ckpt_dir in a fresh session")
        if fail_at_step is not None:
            from repro_torch.runtime.chaos import FaultPlan
            chaos = chaos if chaos is not None else FaultPlan()
            chaos.crash_at = fail_at_step
        total = steps if steps is not None else self.train_cfg.total_steps
        loop_cfg = LoopConfig(
            total_steps=total, ckpt_every=ckpt_every,
            ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
            log_every=log_every if log_every is not None else max(1, total // 20),
            keep_ckpts=keep_ckpts, async_ckpt=async_ckpt)

        def make_step(new_plan):
            # the elastic re-plan arm: a step for the shrunk plan, reading the
            # same resilience config (its replica count follows the new plan)
            return self._device_step(stepfn.make_train_step(self.cfg, new_plan,
                                                            self.train_cfg))

        state, self.state = self.state, None
        out = run_training(state, self._device_step(self.train_step), self.batches, loop_cfg,
                           plan=self.plan, log=log, tracker=tracker,
                           resilience=self.train_cfg.resilience, chaos=chaos, fleet=fleet,
                           make_step=make_step if fleet is not None else None,
                           ckpt_retry=ckpt_retry, mesh=self.mesh, cfg=self.cfg)
        self.state = out["state"]
        if out.get("replans"):
            self.plan = out["plan"]
            self.train_step = stepfn.make_train_step(self.cfg, self.plan, self.train_cfg)
        self._next_step = total
        return out

    def evaluate(self, batch) -> Dict[str, torch.Tensor]:
        """Loss metrics on one batch without touching the optimizer state."""
        return self._eval_step(self.state["params"], self._to_device(batch))

    # ------------------------------------------------------------------
    # hand-offs
    # ------------------------------------------------------------------
    def to_inference(self, *, plan: Optional[ParallelismConfig] = None,
                     mesh=None) -> InferenceSession:
        """Serve the trained weights: a copy in the reference layout (gathered
        over tp, the data axis and the ``pp`` line on a mesh) cast to the
        compute dtype, served on ``mesh`` under ``plan`` (one device by
        default)."""
        params = self.state["params"]
        if self.mesh is not None:
            params = sharding.gather_params(params, self.mesh, self.plan, self.cfg.vocab_size,
                                            self.cfg.d_model,
                                            hints=zero.family_hints(self.cfg))
        params = tree_map(lambda x: x.detach().to(self.cfg.compute_dtype, copy=True), params)
        if mesh is not None:
            return InferenceSession.from_params(self.cfg, params, plan=plan, mesh=mesh,
                                                device=self.device)
        return InferenceSession(self.cfg, params, device=self.device, plan=plan)

    @property
    def n_params(self) -> int:
        return sum(p.numel() for _, p in tree_leaves(self.state["params"]))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<TrainSession {self.cfg.name} on {self.device} plan={self.plan} "
                f"params={self.n_params / 1e6:.1f}M>")
