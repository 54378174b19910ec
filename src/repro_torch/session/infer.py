"""``InferenceSession``: the serving side of the recipe in one object,
mirroring ``repro.session.infer`` on one device.

It owns the compute-dtype parameters on its device, the cache init, the
prefill (``prefill``, without a cache, and the cache-populating
``prefill_cache_step``) and decode steps, the continuous-batching slot operations
(``slot_step``, ``insert_slot``, ``take_slot``, ``zero_slot``), the
block-paged pool's steps (``init_paged_pool``, ``paged_prefill_step``,
``paged_slot_step``, ``pool_copy_page``), a batched greedy ``generate()``
and ``serve()``, which drains a mixed-length request stream through the
continuous-batching scheduler (``repro_torch.session.scheduler``) on
contiguous slots or on the paged pool.  The session runs on the card
unless the caller asks for the CPU; without CUDA the default raises.  The
reference's ``lower_prefill`` / ``lower_decode`` (compile-only dry runs over
a mesh) have no PyTorch counterpart.

With ``plan=`` and ``mesh=`` (a ``launch.mesh.RecipeMesh``) every rank
holds its slices of the weights (``core.sharding.shard_params``) and
``prefill`` and ``generate`` run tensor-parallel, each rank returning the
whole logits and tokens; ``serve`` (the continuous-batching scheduler) runs
on one device only.
"""

from __future__ import annotations

import dataclasses

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import pipeline, sharding, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig


def resolve_config(arch: Union[str, ModelConfig], *, reduced: bool = False) -> ModelConfig:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return cfg.reduced() if reduced else cfg


def _serving(plan: ParallelismConfig) -> ParallelismConfig:
    """The layout a served rank keeps: tp's slices, whole over the data
    axis (every replica serves; ZeRO-3's cut is the train state's)."""
    return dataclasses.replace(plan, zero_stage=min(plan.zero_stage, 1))


def cast_part(cfg: ModelConfig, placement=None):
    """``init_params``' ``finish``: a freshly drawn part of the model (a
    block, the embedding, ...) → this rank's slices of it
    (``placement = (mesh, plan)``), cast to the compute dtype; None for a
    block that another pipeline stage holds (drawn all the same, so the
    generator's sequence is that of one device)."""
    hints = zero.family_hints(cfg)

    def finish(path, part):
        if placement is not None:
            mesh, plan = placement
            if path[0] == "blocks" and not pipeline.holds_layer(
                    path[1], zero.n_stacked(cfg), plan, mesh):
                return None
            part = sharding.shard_params(part, mesh, plan, prefix=path, hints=hints)
        return tree_map(lambda x: x.to(cfg.compute_dtype), part)
    return finish


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this session runs on the card "
                           "unless device='cpu' is asked for")
    return device


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``; host
    arrays go to the card through pinned memory."""
    def one(x):
        t = torch.as_tensor(x)
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return {k: one(x) for k, x in batch.items()}


class InferenceSession:
    def __init__(self, cfg: ModelConfig, params, *, device: torch.device,
                 plan: Optional[ParallelismConfig] = None, mesh=None):
        """``params`` as the session serves them: this rank's slices on a
        mesh."""
        self.cfg = cfg
        self.params = params
        self.device = device
        self.plan = plan if plan is not None else ParallelismConfig()
        self.mesh = mesh
        self.family = model_api.family_of(cfg)
        self.prefill_cache_step = stepfn.make_prefill_cache(cfg, self.plan, mesh)
        self.serve_step = stepfn.make_serve_step(cfg, self.plan, mesh)
        if mesh is None:
            self.slot_step = stepfn.make_slot_serve_step(cfg)
            self.paged_prefill_step = stepfn.make_paged_prefill(cfg)
            self.paged_slot_step = stepfn.make_paged_serve_step(cfg)
        self.last_stats = None  # ServingStats of the most recent serve()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_recipe(cls, arch: Union[str, ModelConfig], *, reduced: bool = False,
                    plan: Optional[ParallelismConfig] = None, mesh=None,
                    seed: int = 0, device: Union[str, torch.device] = "cuda"
                    ) -> "InferenceSession":
        """Fresh random weights from ``seed``, every leaf (norm scales
        included) cast to the compute dtype as the reference does.  On a
        mesh every rank draws the whole model and keeps its slices before
        the cast, so tp = k serves the weights of tp = 1.  Each block is
        drawn in f32, sliced and cast before the next is drawn, so the
        build holds one block in f32 beside the compute-dtype model."""
        device = resolve_device(device)
        cfg = resolve_config(arch, reduced=reduced)
        plan = plan if plan is not None else ParallelismConfig()
        stepfn.check_plan(plan, mesh, cfg)
        stepfn.no_pipeline_mesh("serving", mesh)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        with torch.inference_mode():
            params = model_api.init_params(cfg, gen, finish=cast_part(
                cfg, None if mesh is None else (mesh, _serving(plan))))
        return cls(cfg, params, device=device, plan=plan, mesh=mesh)

    @classmethod
    def from_params(cls, cfg: ModelConfig, params, *,
                    plan: Optional[ParallelismConfig] = None, mesh=None,
                    device: Union[str, torch.device] = "cuda") -> "InferenceSession":
        """Adopt existing whole weights (e.g. bridged from a reference
        checkpoint), moved to ``device`` as they are; on a mesh this rank
        keeps its slices."""
        device = resolve_device(device)
        plan = plan if plan is not None else ParallelismConfig()
        stepfn.check_plan(plan, mesh, cfg)
        stepfn.no_pipeline_mesh("serving", mesh)
        params = tree_map(lambda x: torch.as_tensor(x).to(device), params)
        if mesh is not None:
            params = sharding.shard_params(params, mesh, _serving(plan),
                                           hints=zero.family_hints(cfg))
        return cls(cfg, params, device=device, plan=plan, mesh=mesh)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def prefill(self, batch, *, last_only: bool = True) -> torch.Tensor:
        """Teacher-forced full-sequence forward (the prefill phase), without
        a cache: fp32 logits (B, 1, V) for the last position when
        ``last_only``, else (B, S, V).  ``batch`` holds ``tokens`` (B, S)
        (and optionally ``segment_ids``), numpy or tensors, moved to the
        session's device."""
        step = stepfn.make_prefill(self.cfg, self.plan, self.mesh, last_only=last_only)
        return step(self.params, to_device(batch, self.device))

    def init_cache(self, batch_size: int, max_len: int) -> Any:
        return model_api.init_cache(self.cfg, self.params, batch_size, max_len)

    # continuous-batching slot operations, in place on the caches
    def insert_slot(self, caches, slot_caches, i: int):
        """Write slot-width-1 ``slot_caches`` into request slot ``i``."""
        return stepfn.cache_insert_slot(self.cfg, caches, slot_caches, i)

    def take_slot(self, caches, i: int):
        """Request slot ``i`` of batched caches, slot-width 1 (views)."""
        return stepfn.cache_take_slot(self.cfg, caches, i)

    def zero_slot(self, caches, i: int):
        """Reset request slot ``i`` (positions -1, K/V 0): retire uses this
        so a freed slot never holds stale K/V."""
        return stepfn.cache_zero_slot(self.cfg, caches, i)

    # block-paged KV pool (repro_torch.session.kvpool)
    def init_paged_pool(self, n_pages: int, page_size: int):
        """Device KV page pool, per layer k/v (n_pages, page_size,
        n_kv_heads, head_dim) in the compute dtype (page 0 is the trash
        page)."""
        return model_api.init_paged_pool(self.cfg, self.params, n_pages, page_size)

    def pool_copy_page(self, pool, src: int, dst: int):
        """COW page copy: physical page ``src`` over ``dst`` in every layer."""
        return stepfn.pool_copy_page(self.cfg, pool, src, dst)

    def generate(self, prompts, max_new_tokens, *,
                 stop_token: Optional[int] = None, n_slots: Optional[int] = None):
        """Greedy decode.

        Uniform mode (a 2-D ``prompts`` array and an int ``max_new_tokens``):
        one cache-populating prefill ingests the (B, P) prompts, then argmax
        decode.  Returns (B, P + max_new_tokens) int32 token ids on the
        session's device; after ``stop_token`` a row is padded with it.

        Mixed-length mode (a list of prompts, or per-request
        ``max_new_tokens``): delegates to :meth:`serve` and returns its list
        of per-request 1-D numpy token arrays (stats in ``last_stats``)."""
        if isinstance(prompts, (list, tuple)) or isinstance(max_new_tokens, (list, tuple)):
            outs, _ = self.serve(prompts, max_new_tokens, stop_token=stop_token,
                                 n_slots=n_slots)
            return outs
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.from_numpy(np.asarray(prompts))
        with torch.inference_mode():
            prompts = prompts.to(self.device, torch.int32)
            if max_new_tokens <= 0:
                return prompts
            B, P = prompts.shape
            max_len = P + max_new_tokens
            caches = self.init_cache(B, max_len)
            logits, caches = self.prefill_cache_step(self.params, {"tokens": prompts}, caches)
            tok = logits.argmax(dim=-1).to(torch.int32)
            cols = [prompts, tok[:, None]]
            done = (tok == stop_token) if stop_token is not None else None
            for t in range(P, max_len - 1):
                if done is not None and bool(done.all()):
                    cols.append(torch.full((B, max_len - 1 - t), stop_token,
                                           dtype=torch.int32, device=self.device))
                    break
                nxt, caches = self.serve_step(self.params, tok, t, caches)
                if done is not None:
                    nxt = torch.where(done, stop_token, nxt)
                    done = done | (nxt == stop_token)
                tok = nxt
                cols.append(tok[:, None])
            return torch.cat(cols, dim=1)

    def serve(self, prompts: Sequence, max_new_tokens, *,
              stop_token: Optional[int] = None, n_slots: Optional[int] = None,
              max_len: Optional[int] = None, bucket_prefills: bool = True,
              paged: bool = False, page_size: int = 16, n_pages: Optional[int] = None,
              prefix_sharing: bool = True, scheduler=None):
        """Continuous-batching serve of a mixed-length request set.  Returns
        (list of per-request 1-D token arrays in submit order,
        ``ServingStats``).

        ``bucket_prefills`` pads admission prefills to power-of-two prompt
        lengths (masked: outputs are unchanged).  ``paged=True`` serves from
        the block-paged KV pool (per-request page tables over shared
        physical pages, prefix-cache reuse of identical prompt prefixes,
        copy-on-write growth); greedy outputs stay token-identical to the
        contiguous-slot path.  Pass a previously returned ``scheduler`` to
        keep its prefix cache warm across calls.  One device only."""
        stepfn.one_device("serve", self.mesh)
        from repro_torch.session.scheduler import (ContinuousBatchingScheduler,
                                                   RequestQueue, ServingStats)
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        if isinstance(max_new_tokens, (list, tuple)):
            mnt = [int(m) for m in max_new_tokens]
        else:
            mnt = [int(max_new_tokens)] * len(prompts)
        if len(mnt) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(mnt)} max_new_tokens")
        if not prompts:
            self.last_stats = ServingStats()
            return [], self.last_stats
        if n_slots is None:
            n_slots = min(4, len(prompts))
        if max_len is None:
            max_len = max(len(p) + m for p, m in zip(prompts, mnt))
        queue = RequestQueue()
        rids = [queue.submit(p, m, stop_token=stop_token) for p, m in zip(prompts, mnt)]
        sched = scheduler if scheduler is not None else ContinuousBatchingScheduler(
            self, n_slots=n_slots, max_len=max_len, bucket_prefills=bucket_prefills,
            paged=paged, page_size=page_size, n_pages=n_pages,
            prefix_sharing=prefix_sharing)
        outputs, stats = sched.run(queue)
        self.last_stats = stats
        return [outputs[r] for r in rids], stats

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<InferenceSession {self.cfg.name} on {self.device}>"
