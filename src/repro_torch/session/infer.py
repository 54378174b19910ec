"""``InferenceSession``: the serving side of the recipe in one object,
mirroring ``repro.session.infer`` for uniform batches on one device.

It owns the compute-dtype parameters on its device, the cache init, the
prefill and decode steps, and a batched greedy ``generate()``.  The session
runs on the card unless the caller asks for the CPU; without CUDA the
default raises.  ``serve()``, the slot operations and the paged steps come
with the continuous-batching scheduler's port.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import stepfn
from repro_torch.core.tree import tree_map
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig


def resolve_config(arch: Union[str, ModelConfig], *, reduced: bool = False) -> ModelConfig:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return cfg.reduced() if reduced else cfg


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this session runs on the card "
                           "unless device='cpu' is asked for")
    return device


class InferenceSession:
    def __init__(self, cfg: ModelConfig, params, *, device: torch.device):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.family = model_api.family_of(cfg)
        self.prefill_cache_step = stepfn.make_prefill_cache(cfg)
        self.serve_step = stepfn.make_serve_step(cfg)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_recipe(cls, arch: Union[str, ModelConfig], *, reduced: bool = False,
                    seed: int = 0, device: Union[str, torch.device] = "cuda"
                    ) -> "InferenceSession":
        """Fresh random weights from ``seed``, every leaf (norm scales
        included) cast to the compute dtype as the reference does."""
        device = resolve_device(device)
        cfg = resolve_config(arch, reduced=reduced)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        with torch.inference_mode():
            params = model_api.init_params(cfg, gen)
            params = tree_map(lambda x: x.to(cfg.compute_dtype), params)
        return cls(cfg, params, device=device)

    @classmethod
    def from_params(cls, cfg: ModelConfig, params, *,
                    device: Union[str, torch.device] = "cuda") -> "InferenceSession":
        """Adopt existing weights (e.g. bridged from a reference checkpoint),
        moved to ``device`` as they are."""
        device = resolve_device(device)
        params = tree_map(lambda x: torch.as_tensor(x).to(device), params)
        return cls(cfg, params, device=device)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> Any:
        return model_api.init_cache(self.cfg, self.params, batch_size, max_len)

    def generate(self, prompts, max_new_tokens, *,
                 stop_token: Optional[int] = None) -> torch.Tensor:
        """Greedy decode of a uniform batch: one cache-populating prefill
        ingests the (B, P) prompts, then argmax decode.  Returns
        (B, P + max_new_tokens) int32 token ids on the session's device;
        after ``stop_token`` a row is padded with it."""
        if isinstance(prompts, (list, tuple)) or isinstance(max_new_tokens, (list, tuple)):
            raise NotImplementedError(
                "mixed-length generate needs the continuous-batching scheduler, "
                "which a later PR ports (ROADMAP queue 1, item 5)")
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

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<InferenceSession {self.cfg.name} on {self.device}>"
