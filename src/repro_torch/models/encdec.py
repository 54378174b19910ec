"""Whisper-style encoder-decoder backbone, mirroring ``repro.models.encdec``.

The conv audio frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames`` (B, F, d), F the config's
``enc_frames``.  Parameters are the reference's tree with its stacked
``enc_blocks``/``dec_blocks`` leaves (L, ...) as lists of per-layer dicts,
and its ``lax.scan`` over layers a Python loop; under a remat policy other
than "none" each block is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does for every policy.

The encoder's self-attention is K1 non-causal over the frames; the decoder
runs K1 causal over its tokens and K1 non-causal for its cross-attention,
queries over the decoder's tokens and keys over the frames (Sq != Sk); a
training step runs K2-K4 on all three.  The decode caches are ``{"cross":
[{"k", "v", "pos"}, ...], "self": [{"k", "v", "pos"}, ...]}``, one entry a
decoder layer with the request slot on axis 0 (the reference stacks them
(L, B, ...)): the encoder runs once at cache init and each layer's cross
K/V is computed there; a decode step writes its self-attention ring in
place (K5) and reads the cross K/V through the masked einsum, as the
reference's does.  A prompt goes into the caches through the decode scan
(the reference's default ``prefill_cache``).

Under tensor parallelism (Megatron's regions, ``core.tp``) the encoder's and
the decoder's self-attention and MLP run as the dense stack's; under
sequence parallel both streams lie over tp (the frames' and the tokens'
counts divisible by it).  The cross K/V are cut by heads and read the
encoder's output whole: it enters the tp region once a forward (gathered
over the sequence under sequence parallel) and every layer reads it.  The
caches hold each layer's cross K/V and self ring at this rank's heads.
The learned position tables stay whole, as the rules place them; the
vocabulary table is cut over tp where tp divides it (whisper-base's 51865
rows stay whole) and the unembed is vocab-parallel then.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tp, zero
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_init, cache_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"norm1": layers.norm_init(cfg.norm, cfg.d_model, dev),
            "attn": attention_init(gen, cfg),
            "norm2": layers.norm_init(cfg.norm, cfg.d_model, dev),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp)}


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"norm1": layers.norm_init(cfg.norm, cfg.d_model, dev),
            "attn": attention_init(gen, cfg),
            "normx": layers.norm_init(cfg.norm, cfg.d_model, dev),
            "xattn": attention_init(gen, cfg, cross=True),
            "norm2": layers.norm_init(cfg.norm, cfg.d_model, dev),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp)}


def encdec_init(gen: torch.Generator, cfg: ModelConfig, *, finish=None) -> Params:
    """fp32 parameters on the generator's device; ``finish(path, part)``
    takes each part as it is drawn (see ``transformer.lm_init``)."""
    done = finish or (lambda path, part: part)
    dev, d = gen.device, cfg.d_model

    def table(rows):
        return torch.randn((rows, d), generator=gen, dtype=torch.float32, device=dev) * 0.02

    return {
        "embed": done(("embed",), layers.embed_init(gen, cfg.vocab_size, d)),
        "enc_pos": done(("enc_pos",), table(cfg.enc_frames)),
        "dec_pos": done(("dec_pos",), table(min(cfg.max_position, 32768))),
        "enc_blocks": [done(("enc_blocks", i), _enc_block_init(gen, cfg))
                       for i in range(cfg.enc_layers)],
        "dec_blocks": [done(("dec_blocks", i), _dec_block_init(gen, cfg))
                       for i in range(cfg.n_layers)],
        "enc_norm": done(("enc_norm",), layers.norm_init(cfg.norm, d, dev)),
        "final_norm": done(("final_norm",), layers.norm_init(cfg.norm, d, dev)),
    }


def _aranges(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _enc_block(cfg: ModelConfig, bp: Params, x: torch.Tensor, pos: torch.Tensor):
    bp = zero.gathered(bp)
    h = layers.norm_apply(cfg.norm, bp["norm1"], x)
    x = x + attention_apply(cfg, bp["attn"], h, pos, causal=False)
    h = layers.norm_apply(cfg.norm, bp["norm2"], x)
    return x + layers.mlp_apply(bp["mlp"], h, gated=cfg.gated_mlp, act=cfg.act, d_ff=cfg.d_ff)


def _dec_block(cfg: ModelConfig, bp: Params, x: torch.Tensor, pos: torch.Tensor,
               enc_out: torch.Tensor):
    bp = zero.gathered(bp)
    h = layers.norm_apply(cfg.norm, bp["norm1"], x)
    x = x + attention_apply(cfg, bp["attn"], h, pos, causal=True)
    h = layers.norm_apply(cfg.norm, bp["normx"], x)
    x = x + attention_apply(cfg, bp["xattn"], h, pos, causal=False, kv_source=enc_out)
    h = layers.norm_apply(cfg.norm, bp["norm2"], x)
    return x + layers.mlp_apply(bp["mlp"], h, gated=cfg.gated_mlp, act=cfg.act, d_ff=cfg.d_ff)


def _remat(fn, remat_policy: str):
    """``fn`` recomputed in the backward unless the policy is "none" (or
    nothing takes gradients)."""
    if remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           remat_policy: str = "full") -> torch.Tensor:
    dt = cfg.compute_dtype
    x = T.seq_layout(frames.to(dt) + params["enc_pos"].to(dt)[None])
    pos = _aranges(x.shape[0], x.shape[1], x.device)
    block = _remat(_enc_block, remat_policy)
    for bp in params["enc_blocks"]:
        x = block(cfg, bp, x, pos)
    return layers.norm_apply(cfg.norm, params["enc_norm"], x)


def decode_train(cfg: ModelConfig, params: Params, enc_out: torch.Tensor,
                 tokens: torch.Tensor, *, remat_policy: str = "full",
                 last_only: bool = False) -> torch.Tensor:
    """→ fp32 logits (B, S, V), or (B, 1, V) when ``last_only`` (sliced
    before the unembed); ``enc_out`` in the residual stream's layout."""
    dt = cfg.compute_dtype
    B, S = tokens.shape
    x = layers.embed_lookup(params["embed"], tokens, dt, cfg.vocab_size)
    x = T.seq_layout(x + params["dec_pos"][:S].to(dt)[None])
    pos = _aranges(B, S, x.device)
    # every layer's cross K/V read the whole frames: entered once
    kv = tp.enter(enc_out)
    block = _remat(_dec_block, remat_policy)
    for bp in params["dec_blocks"]:
        x = block(cfg, bp, x, pos, kv)
    if last_only:
        return T.head_logits(cfg, params, T.gather_seq(x)[:, -1:])
    return T.head_logits(cfg, params, x, seq_sharded=tp.sequence_parallel())


def encdec_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
                remat_policy: str = "full"):
    params = zero.gathered_top(params)
    enc_out = encode(cfg, params, batch["frames"], remat_policy=remat_policy)
    logits = decode_train(cfg, params, enc_out, batch["tokens"], remat_policy=remat_policy)
    xent = layers.cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                                vocab_size=cfg.vocab_size)
    return xent, {"xent": xent, "aux": torch.zeros((), dtype=torch.float32, device=xent.device)}


# ---------------------------------------------------------------------------
# decode: self-attention rings and the precomputed cross-attention K/V
# ---------------------------------------------------------------------------

@torch.no_grad()
def encdec_cache_init(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                      max_len: int) -> Dict[str, Any]:
    """Run the encoder once and compute each decoder layer's cross K/V and
    its self-attention ring (this rank's heads under tp)."""
    enc_out = T.gather_seq(encode(cfg, params, frames, remat_policy="none"))
    B, F_, _ = enc_out.shape
    dt, dev = cfg.compute_dtype, enc_out.device
    cross = []
    for bp in params["dec_blocks"]:
        xa = bp["xattn"]
        k = (enc_out @ xa["wk"].to(dt)).reshape(B, F_, -1, cfg.hd)
        v = (enc_out @ xa["wv"].to(dt)).reshape(B, F_, -1, cfg.hd)
        cross.append({"k": k, "v": v, "pos": _aranges(B, F_, dev).contiguous()})
    return {"cross": cross,
            "self": [cache_init(cfg, B, max_len, window=None, device=dev,
                                n_kv_heads=bp["attn"]["wk"].shape[1] // cfg.hd)
                     for bp in params["dec_blocks"]]}


def encdec_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, t, caches):
    """token: (B,) int; t: an int for every row or a (B,) int32 tensor of one
    position a row → (logits (B, V), caches), the rings updated in place."""
    dt = cfg.compute_dtype
    x = layers.embed_lookup(params["embed"], token[:, None], dt, cfg.vocab_size)
    maxp = params["dec_pos"].shape[0]
    if isinstance(t, torch.Tensor):
        x = x + params["dec_pos"][t.long().clamp_max(maxp - 1)].to(dt)[:, None]
    else:
        x = x + params["dec_pos"][min(t, maxp - 1)].to(dt)[None, None]
    for bp, self_c, cross_c in zip(params["dec_blocks"], caches["self"], caches["cross"]):
        h = layers.norm_apply(cfg.norm, bp["norm1"], x)
        h, _ = attention_decode(cfg, bp["attn"], h, t, self_c, window=None)
        x = x + h
        h = layers.norm_apply(cfg.norm, bp["normx"], x)
        h, _ = attention_decode(cfg, bp["xattn"], h, t, cross_c, cross=True)
        x = x + h
        h = layers.norm_apply(cfg.norm, bp["norm2"], x)
        x = x + layers.mlp_apply(bp["mlp"], h, gated=cfg.gated_mlp, act=cfg.act,
                                 d_ff=cfg.d_ff)
    return T.head_logits(cfg, params, x)[:, 0], caches


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

class EncDecFamily:
    """Whisper-style encoder-decoder: encode the frames once, then decode
    autoregressively against self-attention rings and the precomputed
    cross K/V.  No padded prefill and no paged pool, as the reference's."""

    def init_params(self, cfg, gen, *, finish=None):
        return encdec_init(gen, cfg, finish=finish)

    def loss(self, cfg, params, batch, *, remat_policy="full"):
        return encdec_loss(cfg, params, batch, remat_policy=remat_policy)

    def forward(self, cfg, params, batch, *, last_only=False):
        enc_out = encode(cfg, params, batch["frames"], remat_policy="none")
        return decode_train(cfg, params, enc_out, batch["tokens"], remat_policy="none",
                            last_only=last_only)

    def serve_batch(self, cfg, batch_size, *, device):
        """The stub encoder input a cache init takes when it is given none:
        zero frames, as the reference's."""
        return {"frames": torch.zeros((batch_size, cfg.enc_frames, cfg.d_model),
                                      dtype=torch.float32, device=device)}

    def init_cache(self, cfg, params, batch_size, max_len, batch: Optional[Dict] = None):
        if batch is None or "frames" not in batch:
            raise ValueError("an encoder-decoder's cache init needs encoder frames "
                             "(models.api.init_cache stubs them with serve_batch)")
        return encdec_cache_init(cfg, params, batch["frames"], max_len)

    def decode_step(self, cfg, params, token, t, caches):
        return encdec_decode_step(cfg, params, token, t, caches)

    def prefill_cache(self, cfg, params, batch, caches):
        from repro_torch.models.transformer import lm_prefill_scan
        return lm_prefill_scan(cfg, params, batch, caches, step=encdec_decode_step)

    def supports_padded_prefill(self, cfg):
        return False

    def cache_slot_axes(self, cfg, caches):
        from repro_torch.core.tree import tree_map
        return tree_map(lambda _: 0, caches)

    def supports_paged_cache(self, cfg):
        return False

    def init_paged_pool(self, cfg, params, n_pages, page_size):
        raise NotImplementedError(
            "encdec: paged KV pool unsupported (supports_paged_cache is False)")

    def param_sharding_hints(self, cfg):
        return ()

    def mlp_width(self, cfg):
        return cfg.d_ff

    def extra_input_specs(self, cfg, batch_size):
        """The non-token prefill inputs: {name: (shape, dtype)}."""
        return {"frames": ((batch_size, cfg.enc_frames, cfg.d_model), torch.float32)}
