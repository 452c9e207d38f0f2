"""Whisper-style encoder-decoder (a stub conv frontend): the dense and the
paged serving paths.

Ported from ``repro/models/encdec.py``. As in the reference, the modality
frontend is a stub: a request carries precomputed frame embeddings
``frames (1, S_enc, d_model)``, what the conv stem would give. The
backbone is complete: a non-causal encoder over learned positions, a
causal decoder with cross attention over the encoder output, GELU MLPs and
the tied unembedding.

Dense serving keeps the decoder's self K/V ``(L, B, max_seq, K, dh)`` and
the cross K/V ``(L, B, ENC_SEQ, K, dh)``, zero-padded to ``ENC_SEQ`` when a
slot is written, with each lane's true encoder length in ``enc_len``; the
cross read masks at it (``repro/models/encdec.py:157-191``).

Paged serving keeps the decoder's self K/V in page pools like any dense
family, and the cross K/V in a region of its own pages (``cross_*_pages``)
that ``prefill_cross`` fills once per distinct input and every chunk and
decode step reads through the slot's cross page table, masked at
``cross_len`` (``encdec.py:207-334``). The engine shares and spills those
regions (``serving/engine.py``). The paged decode step takes every product
through ``ops.gemm_rows``, the cross query's too; prefill and the encoder
keep ``torch.matmul``.

The reference's ``lax.scan`` over layer-stacked parameters becomes a loop
over per-layer modules (``enc_layers``, and ``dec_layers`` of
``self_attn``, ``cross_attn`` and ``mlp``), so ``bridge.params_from_
reference`` carries the reference's tree as it is.

Training (:func:`loss_fn`, ``encdec.py:60-134``) runs the encoder and the
decoder over the layer-stacked f32 tree, every layer rematerialized; every
attention goes through ``ops.attention``, so on the card through the flash
kernels: the encoder's and the cross attention's non-causal (the cross
attention's queries over the encoder's ``min(S, 1500)`` keys), the
decoder's causal.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.model_api import ModelFns, Params, PSpec, Tree, meta_tensor

ENC_SEQ = 1500  # whisper: 30 s of audio -> 1500 frames after the conv stem


def build_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    max_pos = cfg.max_position or 32_768
    return {
        **ll.embed_specs(cfg),
        "enc_pos": PSpec((ENC_SEQ, d), ("seq", "embed"), init="normal",
                         cast=True),
        "dec_pos": PSpec((max_pos, d), ("seq", "embed"), init="normal",
                         cast=True),
        "enc_final_ln": PSpec((d,), ("embed",), init="ones"),
        "enc_layers": {
            "attn": ll.attn_specs(cfg, layers=Le),
            "mlp": ll.mlp_specs(cfg, cfg.d_ff, layers=Le),
        },
        "dec_layers": {
            "self_attn": ll.attn_specs(cfg, layers=Ld),
            "cross_attn": ll.attn_specs(cfg, layers=Ld),
            "mlp": ll.mlp_specs(cfg, cfg.d_ff, layers=Ld),
        },
    }


class EncDecLM(nn.Module):
    """Weights of the encoder-decoder: embedding, positions and norms, one
    module per encoder layer (``attn``, ``mlp``) and per decoder layer
    (``self_attn``, ``cross_attn``, ``mlp``)."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        for name, t in tree.items():
            if name not in ("enc_layers", "dec_layers"):
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

        def stack(group: dict, n: int) -> nn.ModuleList:
            return nn.ModuleList(
                nn.ModuleDict({part: Params(**{k: v[i] for k, v in
                                               leaves.items()})
                               for part, leaves in group.items()})
                for i in range(n))

        self.enc_layers = stack(tree["enc_layers"], cfg.n_encoder_layers)
        self.dec_layers = stack(tree["dec_layers"], cfg.n_layers)


def _mlp_residual(lp: nn.ModuleDict, y: torch.Tensor, cfg: ModelConfig,
                  mm: ll.Matmul = torch.matmul) -> torch.Tensor:
    h = ops.rmsnorm(y, lp["mlp"].ln, cfg.norm_eps)
    return y + ll.mlp_forward(lp["mlp"], h, cfg, mm)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: EncDecLM, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_enc, d), any float type -> the encoder output (B,
    S_enc, d) bf16: non-causal attention over learned positions
    (``encdec.py:60-74``)."""
    S = frames.shape[1]
    x = frames.to(torch.bfloat16) + params.enc_pos[None, :S]
    rows = ll.dense_rows(cfg, torch.arange(S, device=x.device))
    for lp in params.enc_layers:
        h = ops.rmsnorm(x, lp["attn"].ln, cfg.norm_eps)
        a, _, _ = ll.attn_forward(lp["attn"], h, cfg, rows, causal=False)
        x = _mlp_residual(lp, x + a, cfg)
    return ops.rmsnorm(x, params.enc_final_ln, cfg.norm_eps)


def _cross_kv(p: nn.Module, enc_out: torch.Tensor):
    """A decoder layer's cross K/V from the encoder output: (B, S_enc, K,
    dh) each, unrotated."""
    return ll._mm(enc_out, p.wk), ll._mm(enc_out, p.wv)


# ---------------------------------------------------------------------------
# Dense serving entry points
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    axes = ("layers", "batch", "seq_fallback", "kv_heads", "head_dim")
    return {
        "self_k": PSpec((L, batch, max_seq, K, dh), axes, init="zeros"),
        "self_v": PSpec((L, batch, max_seq, K, dh), axes, init="zeros"),
        "cross_k": PSpec((L, batch, ENC_SEQ, K, dh), axes, init="zeros"),
        "cross_v": PSpec((L, batch, ENC_SEQ, K, dh), axes, init="zeros"),
        "enc_len": PSpec((1, batch, 1), ("null", "batch", "null_i32"),
                         init="zeros"),
    }


def prefill_fn(params: EncDecLM, batch: dict, cfg: ModelConfig):
    """The encoder over ``frames``, then the decoder over the whole prompt
    from position 0 (``encdec.py:105-154``). Returns the last position's
    logits (1, V) f32 and the batch-1 cache: self K/V (L, 1, S, K, dh),
    cross K/V (L, 1, S_enc, K, dh) and ``enc_len`` (1, 1, 1) int32, the
    true encoder length that decode masks at once the cross cache is
    zero-padded to ``ENC_SEQ``."""
    frames = batch["frames"]
    enc_out = encode(params, frames, cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = ll.embed_lookup(params, tokens) + params.dec_pos[None, :S]
    rows = ll.dense_rows(cfg, torch.arange(S, device=x.device))
    kvs: dict[str, list] = {k: [] for k in ("self_k", "self_v", "cross_k",
                                            "cross_v")}
    for lp in params.dec_layers:
        h = ops.rmsnorm(x, lp["self_attn"].ln, cfg.norm_eps)
        a, k, v = ll.attn_forward(lp["self_attn"], h, cfg, rows)
        x = x + a
        kvs["self_k"].append(k)
        kvs["self_v"].append(v)
        h = ops.rmsnorm(x, lp["cross_attn"].ln, cfg.norm_eps)
        ck, cv = _cross_kv(lp["cross_attn"], enc_out)
        a, _, _ = ll.attn_forward(lp["cross_attn"], h, cfg, rows,
                                  causal=False, kv=(ck, cv))
        kvs["cross_k"].append(ck)
        kvs["cross_v"].append(cv)
        x = _mlp_residual(lp, x + a, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    cache = {k: torch.stack(v) for k, v in kvs.items()}
    cache["enc_len"] = torch.full((1, frames.shape[0], 1), frames.shape[1],
                                  dtype=torch.int32, device=x.device)
    return ll.logits_last(params, x[:, -1], cfg), cache


def decode_fn(params: EncDecLM, cache: Tree, batch: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One batched token step over every lane of the dense cache
    (``encdec.py:157-191``): self attention over ``positions + 1`` keys,
    the cross read over each lane's ``enc_len`` encoder keys (the cache's
    zero pad never attended). Returns (B, V) f32."""
    positions = batch["positions"]
    rows = ll.dense_decode_rows(cfg, positions, cache["self_k"].shape[2])
    lengths = (positions + 1).to(torch.int32)
    enc_len = cache["enc_len"][0, :, 0]
    no_rope = ll.Rows(None, None)
    x = (ll.embed_lookup(params, batch["tokens"])
         + params.dec_pos[positions.long()][:, None])
    for lp, sk, sv, ck, cv in zip(params.dec_layers, cache["self_k"],
                                  cache["self_v"], cache["cross_k"],
                                  cache["cross_v"]):
        h = ops.rmsnorm(x, lp["self_attn"].ln, cfg.norm_eps)
        x = x + ll.attn_decode(lp["self_attn"], h, cfg, rows, lengths, sk, sv)
        h = ops.rmsnorm(x, lp["cross_attn"].ln, cfg.norm_eps)
        x = x + ll.attn_decode(lp["cross_attn"], h, cfg, no_rope, enc_len,
                               ck, cv, update_cache=False)
        x = _mlp_residual(lp, x, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg)


# ---------------------------------------------------------------------------
# Paged serving entry points
# ---------------------------------------------------------------------------


def paged_cache_specs(cfg: ModelConfig, n_slots: int, n_pages: int,
                      page_size: int) -> dict:
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    axes = ("layers", "pages", "page", "kv_heads", "head_dim")
    return {
        "self_k_pages": PSpec((L, n_pages, page_size, K, dh), axes,
                              init="zeros"),
        "self_v_pages": PSpec((L, n_pages, page_size, K, dh), axes,
                              init="zeros"),
    }


def paged_cross_specs(cfg: ModelConfig, n_pages: int, page_size: int) -> dict:
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    axes = ("layers", "pages", "page", "kv_heads", "head_dim")
    return {
        "cross_k_pages": PSpec((L, n_pages, page_size, K, dh), axes,
                               init="zeros"),
        "cross_v_pages": PSpec((L, n_pages, page_size, K, dh), axes,
                               init="zeros"),
    }


def prefill_cross_fn(params: EncDecLM, cache: Tree, batch: dict,
                     cfg: ModelConfig) -> None:
    """Run the encoder over ``batch["frames"]`` (1, S_enc, d) and write each
    decoder layer's cross K/V into the pages of ``batch["cross_page_table"]``
    (max_cross_pages,), in place (``encdec.py:239-267``). Once per
    admission of a distinct input: the pages are read-only afterwards,
    which lets the engine share one region across requests with the same
    frames."""
    enc_out = encode(params, batch["frames"], cfg)
    table = batch["cross_page_table"].long()
    P = cache["cross_k_pages"].shape[2]
    pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    pid, off = table[pos // P], pos % P
    for lp, ckp, cvp in zip(params.dec_layers, cache["cross_k_pages"],
                            cache["cross_v_pages"]):
        k, v = _cross_kv(lp["cross_attn"], enc_out)
        ckp.index_put_((pid, off), k[0].to(ckp.dtype))
        cvp.index_put_((pid, off), v[0].to(cvp.dtype))


def prefill_chunk_fn(params: EncDecLM, cache: Tree, batch: dict,
                     cfg: ModelConfig, *, offset: int) -> torch.Tensor:
    """One decoder-prompt chunk at ``offset`` (``encdec.py:270-303``): the
    self K/V into the slot's pages, the cross read over the already written
    encoder pages of ``cross_page_table``, masked at ``cross_len``.
    Returns the last valid token's logits (1, V) f32."""
    table = batch["page_table"]
    cross_table = batch["cross_page_table"][None]          # (1, max_cp)
    cross_len = batch["cross_len"].reshape(1)              # (1,)
    C = batch["tokens"].shape[1]
    x = ll.embed_lookup(params, batch["tokens"]) \
        + params.dec_pos[None, offset:offset + C]
    P = cache["self_k_pages"].shape[2]
    rows = ll.chunk_rows(cfg, offset, C, table, P)
    n_ctx = min((offset + C + P - 1) // P, table.shape[0])
    ctx = table[:n_ctx].long()
    for lp, skp, svp, ckp, cvp in zip(
            params.dec_layers, cache["self_k_pages"], cache["self_v_pages"],
            cache["cross_k_pages"], cache["cross_v_pages"]):
        h = ops.rmsnorm(x, lp["self_attn"].ln, cfg.norm_eps)
        x = x + ll.attn_prefill_chunk(lp["self_attn"], h, cfg, offset, rows,
                                      ctx, skp, svp)
        h = ops.rmsnorm(x, lp["cross_attn"].ln, cfg.norm_eps)
        x = x + ll.attn_cross_paged(lp["cross_attn"], h, cfg, ckp, cvp,
                                    cross_table, cross_len)
        x = _mlp_residual(lp, x, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    valid = int(batch["valid"])
    return ll.logits_last(params, x[:, valid - 1], cfg)


def decode_paged_fn(params: EncDecLM, cache: Tree, batch: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """One batched token step (``encdec.py:306-334``), every product
    through ``ops.gemm_rows``; the cross read of lane b over its cross
    table row, masked at ``cross_len[b]``. Returns (B, V) f32."""
    positions = batch["positions"]
    table = batch["page_table"]
    mm = ops.gemm_rows
    rows = ll.decode_rows(cfg, positions, table,
                          cache["self_k_pages"].shape[2])
    lengths = (positions + 1).to(torch.int32)
    x = (ll.embed_lookup(params, batch["tokens"])
         + params.dec_pos[positions.long()][:, None])
    for lp, skp, svp, ckp, cvp in zip(
            params.dec_layers, cache["self_k_pages"], cache["self_v_pages"],
            cache["cross_k_pages"], cache["cross_v_pages"]):
        h = ops.rmsnorm(x, lp["self_attn"].ln, cfg.norm_eps)
        x = x + ll.attn_decode_paged(lp["self_attn"], h, cfg, rows, lengths,
                                     skp, svp, table, mm)
        h = ops.rmsnorm(x, lp["cross_attn"].ln, cfg.norm_eps)
        x = x + ll.attn_cross_paged(lp["cross_attn"], h, cfg, ckp, cvp,
                                    batch["cross_page_table"],
                                    batch["cross_len"], mm)
        x = _mlp_residual(lp, x, cfg, mm)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg, mm)


# ---------------------------------------------------------------------------
# Training: the loss over a layer-stacked f32 tree
# ---------------------------------------------------------------------------


def loss_fn(tree: Tree, batch: dict, cfg: ModelConfig):
    """The decoder's language-model loss of ``batch`` (``frames`` (B,
    S_enc, d) float, ``tokens``, ``labels`` (B, S) int) under the
    layer-stacked f32 tree ``tree`` (``encdec.py:60-134``): the encoder
    over the frames plus ``enc_pos`` (non-causal blocks, then
    ``enc_final_ln``); the decoder over the token embedding plus
    ``dec_pos``, each block causal self attention, cross attention over its
    projection of the encoder output, the GELU MLP; the final norm and
    ``ll.lm_loss`` through the tied embedding. The ``cast`` leaves are read
    in bf16, each layer rematerialized per ``cfg.remat_policy``
    (``transformer._remat``). Returns (loss, {"ce", "z_loss",
    "tokens"})."""
    specs = build_specs(cfg)
    groups = ("enc_layers", "dec_layers")
    top = SimpleNamespace(**{k: tf._cast(v, specs[k]) for k, v in tree.items()
                             if k not in groups + ("enc_pos", "dec_pos")})
    (enc_layers, enc_view), (dec_layers, dec_view) = (
        tf._unstack(tree[g], specs[g]) for g in groups)

    def parts(view, leaves) -> SimpleNamespace:
        """One layer's parts (``attn``, ``mlp``, ...) as namespaces."""
        return SimpleNamespace(**{k: SimpleNamespace(**v)
                                  for k, v in view(leaves).items()})

    frames = batch["frames"]
    S_enc, S = frames.shape[1], batch["tokens"].shape[1]
    x = frames.to(torch.bfloat16) + tf._cast(
        tree["enc_pos"][:S_enc], specs["enc_pos"])[None]
    enc_rows = ll.dense_rows(cfg, torch.arange(S_enc, device=x.device))

    def enc_layer(x, *leaves):
        lp = parts(enc_view, leaves)
        h = ops.rmsnorm(x, lp.attn.ln, cfg.norm_eps)
        x = x + ll.attn_forward(lp.attn, h, cfg, enc_rows, causal=False)[0]
        h = ops.rmsnorm(x, lp.mlp.ln, cfg.norm_eps)
        return x + ll.mlp_forward(lp.mlp, h, cfg)

    body = tf._remat(enc_layer, cfg)
    for leaves in enc_layers:
        x = body(x, *leaves)
    enc_out = ops.rmsnorm(x, tree["enc_final_ln"], cfg.norm_eps)

    x = ll.embed_lookup(top, batch["tokens"]) + tf._cast(
        tree["dec_pos"][:S], specs["dec_pos"])[None]
    rows = ll.dense_rows(cfg, torch.arange(S, device=x.device))

    def dec_layer(x, enc_out, *leaves):
        lp = parts(dec_view, leaves)
        h = ops.rmsnorm(x, lp.self_attn.ln, cfg.norm_eps)
        x = x + ll.attn_forward(lp.self_attn, h, cfg, rows)[0]
        h = ops.rmsnorm(x, lp.cross_attn.ln, cfg.norm_eps)
        x = x + ll.attn_forward(lp.cross_attn, h, cfg, rows, causal=False,
                                kv=_cross_kv(lp.cross_attn, enc_out))[0]
        h = ops.rmsnorm(x, lp.mlp.ln, cfg.norm_eps)
        return x + ll.mlp_forward(lp.mlp, h, cfg)

    body = tf._remat(dec_layer, cfg)
    for leaves in dec_layers:
        x = body(x, enc_out, *leaves)
    x = ops.rmsnorm(x, tree["final_ln"], cfg.norm_eps)
    return ll.lm_loss(top, x, batch["labels"], cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A cell's inputs as meta tensors (``encdec.py:337-355``): the train
    and prefill cells add ``frames`` of ``min(seq_len, ENC_SEQ)`` rows; a
    decode cell takes the decoder's token and position."""
    b, s = shape.global_batch, shape.seq_len
    enc = {"frames": meta_tensor((b, min(s, ENC_SEQ), cfg.d_model),
                                 torch.bfloat16)}
    if shape.kind == "train":
        return {**enc, "tokens": meta_tensor((b, s), torch.int32),
                "labels": meta_tensor((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {**enc, "tokens": meta_tensor((b, s), torch.int32)}
    return {"tokens": meta_tensor((b, 1), torch.int32),
            "positions": meta_tensor((b,), torch.int32)}


def make_model(cfg: ModelConfig) -> ModelFns:
    # the whole per-token decoder cache lives in page pools (paged_state
    # False), so decoder prompt prefixes share copy-on-write; the engine
    # salts their trie keys with the frames' digest
    return ModelFns(
        cfg=cfg,
        param_specs=build_specs(cfg),
        build=functools.partial(EncDecLM, cfg),
        cache_specs=functools.partial(cache_specs, cfg),
        prefill=functools.partial(prefill_fn, cfg=cfg),
        decode_step=functools.partial(decode_fn, cfg=cfg),
        paged_cache_specs=functools.partial(paged_cache_specs, cfg),
        prefill_chunk=functools.partial(prefill_chunk_fn, cfg=cfg),
        decode_paged=functools.partial(decode_paged_fn, cfg=cfg),
        paged_cross_specs=functools.partial(paged_cross_specs, cfg),
        prefill_cross=functools.partial(prefill_cross_fn, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        input_specs=functools.partial(input_specs, cfg),
    )
