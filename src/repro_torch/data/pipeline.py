"""Deterministic, resumable data pipeline, a copy of ``repro.data.pipeline``
(numpy only): every batch is a pure function of (seed, step), so the port
and the reference train on the same tokens.

Design goals that matter at 1000-node scale:
  * every batch is a pure function of (seed, step) — restarted/elastic
    replicas rejoin the schedule with zero coordination;
  * iterator state is one integer (the step), checkpointed with the model;
  * per-host slicing by (host_id, num_hosts) so no host materializes the
    global batch;
  * the memmap path streams from disk (DAOS/GCS in production) with no copy.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 1234
    path: Optional[str] = None          # .bin memmap of uint16/uint32 tokens
    host_id: int = 0
    num_hosts: int = 1
    # sequence packing: EOS-delimited documents share fixed seq_len rows; the
    # batch grows a ``segment_ids`` key (attention stays within a document —
    # see models.attention.sdpa) and the loss mask zeroes labels that cross a
    # document boundary.  No pad tokens → every FLOP the cost model bills is
    # spent on real data.
    pack_documents: bool = False
    eos_id: int = 0                     # document delimiter token


def pack_segments(rows: np.ndarray, eos_id: int) -> Dict[str, np.ndarray]:
    """Packed batch from contiguous EOS-delimited rows of (S+1) tokens.

    Every token belongs to the document its preceding EOS closed: segment id
    at position i counts the EOS tokens strictly before i, so an EOS is the
    LAST token of its document.  The loss mask keeps the EOS prediction (a
    real modeling target) and zeroes exactly the positions whose label is
    the first token of the NEXT document (``tokens == eos``)."""
    rows = np.ascontiguousarray(rows)
    tokens = rows[:, :-1].astype(np.int32)
    labels = rows[:, 1:].astype(np.int32)
    boundaries = np.cumsum(rows == eos_id, axis=1)
    seg = np.concatenate(
        [np.zeros((rows.shape[0], 1), np.int32),
         boundaries[:, :-1].astype(np.int32)], axis=1)
    return {
        "tokens": tokens,
        "labels": labels,
        "loss_mask": (tokens != eos_id).astype(np.float32),
        "segment_ids": seg[:, :-1],
    }


def batch_fingerprint(batch: Dict[str, np.ndarray]) -> str:
    """Content hash of a batch's token/label arrays (forensics: a skip event
    logs this next to the data index, so a bad shard can be identified by
    content even after the file moved or the cursor was fast-forwarded past
    it).  Keys are hashed in sorted order; non-data keys (chaos scales,
    modality embeds) are excluded so the hash is stable across harnesses."""
    h = hashlib.sha1()
    for k in ("tokens", "labels"):
        v = batch.get(k)
        if v is not None:
            h.update(k.encode())
            h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()[:16]


def estimate_mean_doc_len(tokens: np.ndarray, eos_id: int) -> float:
    """Mean EOS-delimited document length over a token sample (B, S): total
    tokens over document count, where each row contributes its EOS count
    plus one trailing partial document.  Feeds the advisor's packing hint —
    when this is far below ``seq_len``, unpacked rows are mostly padding or
    cross-document waste."""
    tokens = np.asarray(tokens)
    n_docs = int((tokens == eos_id).sum()) + tokens.shape[0]
    return float(tokens.size) / n_docs


class TokenDataset:
    """Base: deterministic batch(step) → {tokens, labels, loss_mask}
    (+ ``segment_ids`` on the packed path)."""

    def __init__(self, cfg: DataConfig, vocab: int):
        self.cfg = cfg
        self.vocab = vocab
        assert cfg.global_batch % cfg.num_hosts == 0
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class SyntheticLM(TokenDataset):
    """Structured synthetic LM data (learnable patterns, not pure noise):
    a token-level Markov-ish stream derived from a counter-based RNG, so the
    loss actually decreases — useful for convergence smoke tests."""

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        B, S = self.local_batch, c.seq_len
        row0 = c.host_id * B
        # counter-based: sequence i of step s is fully determined by (seed, s, i)
        rng = np.random.Generator(np.random.Philox(key=[c.seed + (step << 20), row0]))
        if c.pack_documents:
            # the same learnable walk, cut into EOS-delimited documents that
            # pack the row edge-to-edge (geometric doc lengths, ~4 docs/row)
            rows = self._walk(rng, B, S + 1)
            rows = np.where(rows == c.eos_id, (c.eos_id + 1) % self.vocab, rows)
            cut = rng.random((B, S + 1)) < 4.0 / (S + 1)
            rows = np.where(cut, c.eos_id, rows)
            return pack_segments(rows, c.eos_id)
        toks = self._walk(rng, B, S)
        tokens = toks[:, :-1] if S > 1 else toks
        labels = toks[:, 1:] if S > 1 else toks
        pad = np.zeros((B, 1), np.int32)
        return {
            "tokens": np.concatenate([tokens, pad], 1)[:, :S],
            "labels": np.concatenate([labels, pad], 1)[:, :S],
            "loss_mask": np.concatenate(
                [np.ones((B, S - 1), np.float32), np.zeros((B, 1), np.float32)], 1),
        }

    def _walk(self, rng, B: int, S: int) -> np.ndarray:
        # piecewise-linear token walks with noise → learnable local structure
        starts = rng.integers(0, self.vocab, (B, 1))
        steps = rng.integers(-3, 4, (B, S))
        walk = (starts + np.cumsum(steps, axis=1)) % self.vocab
        noise = rng.integers(0, self.vocab, (B, S))
        take_noise = rng.random((B, S)) < 0.05
        return np.where(take_noise, noise, walk).astype(np.int32)


class MemmapLM(TokenDataset):
    """Streams contiguous windows from a flat token file.

    Window schedule: window index is pure modulo-``n_windows`` arithmetic
    over the global step offset, so (a) every window is reachable as a base,
    (b) the ``global_batch`` indices of one step are distinct residues —
    host shards stay disjoint even across a wrap — and (c) a file too small
    for one global batch fails loudly instead of silently replaying the
    same windows every step."""

    def __init__(self, cfg: DataConfig, vocab: int):
        super().__init__(cfg, vocab)
        assert cfg.path is not None
        self.data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.n_tokens = len(self.data)
        self.n_windows = self.n_tokens // (cfg.seq_len + 1)
        if self.n_windows < cfg.global_batch:
            raise ValueError(
                f"{cfg.path}: {self.n_windows} windows of seq_len+1="
                f"{cfg.seq_len + 1} tokens cannot fill one global batch of "
                f"{cfg.global_batch}")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        B, S = self.local_batch, c.seq_len
        base = (step * c.global_batch + c.host_id * B) % self.n_windows
        idx = (base + np.arange(B)) % self.n_windows
        rows = np.stack([self.data[i * (S + 1):(i + 1) * (S + 1)] for i in idx])
        rows = rows.astype(np.int32) % self.vocab
        if c.pack_documents:
            return pack_segments(rows, c.eos_id)
        return {
            "tokens": rows[:, :-1],
            "labels": rows[:, 1:],
            "loss_mask": np.ones((B, S), np.float32),
        }


def make_dataset(cfg: DataConfig, model_cfg: ModelConfig) -> TokenDataset:
    ds: TokenDataset
    if cfg.path:
        ds = MemmapLM(cfg, model_cfg.vocab_size)
    else:
        ds = SyntheticLM(cfg, model_cfg.vocab_size)
    return ds


def add_modality_inputs(batch: Dict[str, np.ndarray], model_cfg: ModelConfig,
                        step: int, seed: int = 7) -> Dict[str, np.ndarray]:
    """Stub frontends: precomputed vision/audio embeddings (assignment spec)."""
    B = batch["tokens"].shape[0]
    rng = np.random.Generator(np.random.Philox(key=[seed, step]))
    if model_cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, model_cfg.n_vision_tokens, model_cfg.d_model), np.float32)
    if model_cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, model_cfg.enc_frames, model_cfg.d_model), np.float32)
    return batch


def batch_iterator(ds: TokenDataset, model_cfg: ModelConfig,
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        b = ds.batch(step)
        yield add_modality_inputs(b, model_cfg, step, ds.cfg.seed)
        step += 1
