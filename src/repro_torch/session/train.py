"""``TrainSession``: a training lifecycle in one object, mirroring
``repro.session.train`` on one device.

It resolves the architecture config, builds the train state (fp32 master
weights from ``seed``, AdamW moments), the single-device train step and the
deterministic data pipeline (batch = f(seed, step)), and steps.  The
session runs on the card unless the caller asks for the CPU; without CUDA
the default raises.

Typical use::

    sess = TrainSession.from_recipe("granite_3_2b", reduced=True, device="cpu",
                                    data_cfg=DataConfig(seq_len=64, global_batch=4))
    for _ in range(3):
        metrics = sess.step()
    inf = sess.to_inference()            # serve the trained weights

The fault-tolerant loop (``run``), checkpoint writing, the mesh, the
recipe advisor and the abstract (dry-run) mode come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core import stepfn
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig, make_dataset
from repro_torch.data.pipeline import add_modality_inputs
from repro_torch.models.config import ModelConfig
from repro_torch.session.infer import InferenceSession, resolve_config, resolve_device


class TrainSession:
    def __init__(self, cfg: ModelConfig, *,
                 plan: Optional[ParallelismConfig] = None,
                 train_cfg: Optional[stepfn.TrainConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan = plan if plan is not None else ParallelismConfig()
        self.train_cfg = train_cfg if train_cfg is not None else stepfn.TrainConfig()
        self.data_cfg = data_cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.state = stepfn.init_state(cfg, self.plan, gen, self.train_cfg)
        self.train_step = stepfn.make_train_step(cfg, self.plan, self.train_cfg)
        self._eval_step = stepfn.make_eval_step(cfg, self.plan)
        self._dataset = None
        self._batch_cache: Dict[int, Any] = {}
        self._next_step = 0

    @classmethod
    def from_recipe(cls, arch: Union[str, ModelConfig], *, reduced: bool = False,
                    plan: Optional[ParallelismConfig] = None,
                    train_cfg: Optional[stepfn.TrainConfig] = None,
                    data_cfg: Optional[DataConfig] = None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda") -> "TrainSession":
        """Architecture name (or config) + recipe → a training session."""
        cfg = resolve_config(arch, reduced=reduced)
        return cls(cfg, plan=plan, train_cfg=train_cfg, data_cfg=data_cfg, seed=seed,
                   device=device)

    # ------------------------------------------------------------------
    # data pipeline (deterministic, resumable: batch = f(seed, step))
    # ------------------------------------------------------------------
    @property
    def dataset(self):
        if self._dataset is None:
            dc = self.data_cfg or DataConfig(seq_len=256, global_batch=32)
            self._dataset = make_dataset(dc, self.cfg)
        return self._dataset

    def batches(self, step: int) -> Dict[str, np.ndarray]:
        """The numpy batch for ``step`` (one-slot cache)."""
        if step not in self._batch_cache:
            self._batch_cache.clear()
            b = self.dataset.batch(step)
            self._batch_cache[step] = add_modality_inputs(b, self.cfg, step,
                                                          self.dataset.cfg.seed)
        return self._batch_cache[step]

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        def one(x):
            t = torch.as_tensor(x)
            if self.device.type == "cuda" and t.device.type == "cpu":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return {k: one(x) for k, x in batch.items()}

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

    def evaluate(self, batch) -> Dict[str, torch.Tensor]:
        """Loss metrics on one batch without touching the optimizer state."""
        return self._eval_step(self.state["params"], self._to_device(batch))

    # ------------------------------------------------------------------
    # hand-offs
    # ------------------------------------------------------------------
    def to_inference(self) -> InferenceSession:
        """Serve the trained weights: a copy cast to the compute dtype."""
        params = tree_map(lambda x: x.detach().to(self.cfg.compute_dtype, copy=True),
                          self.state["params"])
        return InferenceSession(self.cfg, params, device=self.device)

    @property
    def n_params(self) -> int:
        return sum(p.numel() for _, p in tree_leaves(self.state["params"]))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<TrainSession {self.cfg.name} on {self.device} plan={self.plan} "
                f"params={self.n_params / 1e6:.1f}M>")
