"""``EvalSession``: held-out evaluation over the eval step that
``TrainSession.evaluate`` runs, without the optimizer state; the live mode
of ``repro.session.evalsess`` on one device.

``evaluate(batch)`` gives one batch's metrics and the count of tokens that
bear loss; ``perplexity(batches)`` is the token-weighted sweep (each
batch's mean xent weighted by its masked token count, so a ragged final
batch does not skew the aggregate).  On a mesh (``mesh=``, as
``TrainSession``'s) it evaluates this rank's slices tensor-parallel.  The
session runs on the card unless
the caller asks for the CPU; without CUDA the default raises.  The
reference's abstract mode (``abstract=``, ``lower``, ``make_jaxpr``: a
sharded lowering that its lint auditor reads) has no PyTorch counterpart.

Typical use::

    ev = EvalSession.from_train_session(sess)      # share the trained params
    report = ev.perplexity(sess.batches(s) for s in range(100, 110))
    report["perplexity"], report["n_tokens"]
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core import stepfn
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.session.infer import cast_part, resolve_config, resolve_device, to_device


class EvalSession:
    def __init__(self, cfg: ModelConfig, *, plan: Optional[ParallelismConfig] = None,
                 params: Any = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        """Without ``params``: fresh weights from ``seed`` on ``device``
        (this rank's slices on a mesh), every leaf cast to the compute
        dtype, block by block as ``InferenceSession.from_recipe`` builds
        them.  Given ``params`` are taken as they are (sliced already on a
        mesh)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan = plan if plan is not None else ParallelismConfig()
        self.mesh = mesh
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            with torch.no_grad():
                params = model_api.init_params(cfg, gen, finish=cast_part(
                    cfg, None if mesh is None else (mesh, self.plan)))
        self.params = params
        self.eval_step = stepfn.make_eval_step(cfg, self.plan, mesh)

    @classmethod
    def from_recipe(cls, arch: Union[str, ModelConfig], *, reduced: bool = False,
                    plan: Optional[ParallelismConfig] = None, params: Any = None,
                    seed: int = 0, device: Union[str, torch.device] = "cuda"
                    ) -> "EvalSession":
        return cls(resolve_config(arch, reduced=reduced), plan=plan, params=params,
                   seed=seed, device=device)

    @classmethod
    def from_train_session(cls, sess) -> "EvalSession":
        """Evaluate a ``TrainSession``'s current weights in place (no copy,
        no cast: the eval step reads whatever dtype training holds)."""
        return cls(sess.cfg, plan=sess.plan, params=sess.state["params"], device=sess.device,
                   mesh=sess.mesh)

    def evaluate(self, batch) -> Dict[str, Any]:
        """Metrics on one batch (0-d tensors on the device) and the count of
        tokens the sweep weights by: ``loss_mask``'s sum, else every
        token."""
        metrics = dict(self.eval_step(self.params, to_device(batch, self.device)))
        mask = batch.get("loss_mask")
        if mask is None:
            metrics["n_tokens"] = float(np.prod(tuple(batch["tokens"].shape)))
        else:
            metrics["n_tokens"] = float(torch.as_tensor(mask).sum())
        return metrics

    def perplexity(self, batches: Iterable[Any]) -> Dict[str, float]:
        """Token-weighted perplexity sweep: exp(Σ xent_b·n_b / Σ n_b)."""
        nll_sum, tok_sum, n_batches = 0.0, 0.0, 0
        for batch in batches:
            m = self.evaluate(batch)
            nll_sum += float(m["xent"]) * m["n_tokens"]
            tok_sum += m["n_tokens"]
            n_batches += 1
        if tok_sum == 0:
            raise ValueError("perplexity sweep saw no loss-bearing tokens")
        xent = nll_sum / tok_sum
        return {"perplexity": math.exp(min(xent, 700.0)), "xent": xent,
                "n_tokens": tok_sum, "n_batches": n_batches}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<EvalSession {self.cfg.name} on {self.device} plan={self.plan}>"
