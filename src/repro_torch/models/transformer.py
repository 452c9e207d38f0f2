"""Dense decoder-only transformer (qwen3, smollm, phi4-mini, minitron) and
the LLaVA-NeXT VLM (a stub vision frontend on a Mistral backbone): the
dense and the paged serving paths.

Ported from ``repro/models/transformer.py``. The reference's ``lax.scan``
over layer-stacked parameters becomes a loop over per-layer modules; the
caches stay layer-stacked — page pools ``(L, n_pages, P, K, dh)``, the
dense cache ``(L, B, max_seq, K, dh)`` — and layer ``l`` updates its slice
``cache[...][l]`` in place.

The paged decode step takes its matrix products through ``ops.gemm_rows``,
whose rows do not depend on the row count, and the speculative verify
folds its ``B·W`` window lanes into that step (``verify_paged_fn``): so a
verified token's logits are a plain decode step's, bit for bit, on the card
too. Prefill and the dense path keep ``torch.matmul``.

The VLM family's image rows are precomputed patch embeddings (``embeds``,
``(1, n_image_tokens, VISION_D)``; the vision tower is a stub in the
reference too) projected by ``mm_proj`` and placed ahead of the text: a
dense prefill concatenates them (``_embed_inputs``), and a paged prefill
chunk reads them inline for its positions below ``mm_len``, so image rows
take ordinary pages and share through the prefix trie like text
(``repro/models/transformer.py:83-90, 186-223``).

The MoE family (``models/moe.py``) serves through these same entry points:
its layers are blocks too, whose ``ffn`` routes through the experts, and
the paged decode step hands them ``ops.gemm_rows_grouped`` for the routed
experts' products beside ``ops.gemm_rows`` for every other product.
"""

from __future__ import annotations

import contextlib
import functools
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models.model_api import (ModelFns, Params, PSpec, Tree,
                                          meta_tensor,
                                          standard_input_specs)
from repro_torch.parallel.partition import shard

VISION_D = 1024  # stub vision-tower embedding width (CLIP-like)


def build_specs(cfg: ModelConfig) -> dict:
    L = cfg.n_layers
    specs = {
        **ll.embed_specs(cfg),
        "layers": {
            "attn": ll.attn_specs(cfg, layers=L),
            "mlp": ll.mlp_specs(cfg, cfg.d_ff, layers=L),
        },
    }
    if cfg.family == "vlm":
        specs["mm_proj"] = PSpec((VISION_D, cfg.d_model),
                                 ("embed_in", "embed"), cast=True)
    return specs


class Block(nn.Module):
    def __init__(self, attn: dict, mlp: dict):
        super().__init__()
        self.attn = Params(**attn)
        self.mlp = Params(**mlp)

    def ffn(self, h: torch.Tensor, cfg: ModelConfig, mm: ll.Matmul,
            grouped=None) -> torch.Tensor:
        """The block's MLP on the normalized ``h`` (a dense block takes no
        grouped product)."""
        return ll.mlp_forward(self.mlp, h, cfg, mm)


class DenseLM(nn.Module):
    """Weights of a dense decoder: embedding, one :class:`Block` per layer,
    final norm and (untied) unembedding."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        top = {k: v for k, v in tree.items() if k != "layers"}
        for name, t in top.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        stacked = tree["layers"]
        self.layers = nn.ModuleList(
            Block({k: v[i] for k, v in stacked["attn"].items()},
                  {k: v[i] for k, v in stacked["mlp"].items()})
            for i in range(cfg.n_layers)
        )


def _residual_shard(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequence parallelism (``transformer.py:53-61``): under a mesh, the
    residual stream of a ``seq_parallel`` config keeps its sequence dim
    sharded over the model axis between blocks; otherwise ``x``."""
    if cfg.seq_parallel:
        return shard(x, "batch", "seq_model", None)
    return x


def _block(lp: Block, x: torch.Tensor, cfg: ModelConfig, attend,
           mm: ll.Matmul = torch.matmul, grouped=None):
    """Pre-norm attention (``attend(p, h)``, the call's attention) + the
    block's MLP (``lp.ffn``; ``grouped`` is the routed experts' product of
    an MoE block, None for ``torch.bmm``)."""
    h = ops.rmsnorm(x, lp.attn.ln, cfg.norm_eps)
    y = _residual_shard(x + attend(lp.attn, h), cfg)
    h = ops.rmsnorm(y, lp.mlp.ln, cfg.norm_eps)
    return _residual_shard(y + lp.ffn(h, cfg, mm, grouped), cfg)


# ---------------------------------------------------------------------------
# Dense serving entry points
# ---------------------------------------------------------------------------


def _image_rows(params: DenseLM, embeds: torch.Tensor) -> torch.Tensor:
    """Patch embeddings (1, n, VISION_D), any float type, cast to bf16 and
    projected: (1, n, d)."""
    return ll._mm(embeds.to(torch.bfloat16), params.mm_proj)


def _embed_inputs(params: DenseLM, cfg: ModelConfig,
                  batch: dict) -> torch.Tensor:
    """Token embeddings, with a VLM's image rows ahead of them
    (``transformer.py:83-90``)."""
    x = ll.embed_lookup(params, batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([_image_rows(params, batch["embeds"]), x], dim=1)
    return x


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    axes = ("layers", "batch", "seq_fallback", "kv_heads", "head_dim")
    return {
        "k": PSpec((L, batch, max_seq, K, dh), axes, init="zeros"),
        "v": PSpec((L, batch, max_seq, K, dh), axes, init="zeros"),
    }


def prefill_fn(params: DenseLM, batch: dict, cfg: ModelConfig):
    """The whole prompt from position 0 (``transformer.py:131-143``): causal
    attention over every position, pads included, a VLM's image rows
    first. Returns the logits of the last position (1, V) f32 and the
    batch-1 cache ``k``/``v`` (L, 1, S, K, dh)."""
    x = _embed_inputs(params, cfg, batch)                 # (1, S, d)
    rows = ll.dense_rows(cfg, torch.arange(x.shape[1], device=x.device))
    ks, vs = [], []

    def attend(p, h):
        out, k, v = ll.attn_forward(p, h, cfg, rows)
        ks.append(k)
        vs.append(v)
        return out

    for lp in params.layers:
        x = _block(lp, x, cfg, attend)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return ll.logits_last(params, x[:, -1], cfg), cache


def decode_fn(params: DenseLM, cache: Tree, batch: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One batched token step over every lane of the dense cache
    (``transformer.py:146-159``). Returns (B, V) f32."""
    positions = batch["positions"]
    rows = ll.dense_decode_rows(cfg, positions, cache["k"].shape[2])
    lengths = (positions + 1).to(torch.int32)
    x = ll.embed_lookup(params, batch["tokens"])          # (B, 1, d)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = _block(lp, x, cfg, lambda p, h: ll.attn_decode(
            p, h, cfg, rows, lengths, ck, cv))
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
        "k_pages": PSpec((L, n_pages, page_size, K, dh), axes, init="zeros"),
        "v_pages": PSpec((L, n_pages, page_size, K, dh), axes, init="zeros"),
    }


def prefill_chunk_fn(params: DenseLM, cache: Tree, batch: dict,
                     cfg: ModelConfig, *, offset: int,
                     mm_len: int = 0) -> torch.Tensor:
    """One prompt chunk at absolute position ``offset`` (``transformer.py:
    186-223``): K/V written into the slot's pages, logits taken at the true
    final token (``valid - 1`` within the chunk). A VLM chunk's positions
    below ``mm_len`` read the projected image rows of ``batch["embeds"]``
    (1, C, VISION_D), aligned with the chunk, instead of token embeddings.
    Returns (1, V) f32."""
    table = batch["page_table"]
    x = ll.embed_lookup(params, batch["tokens"])          # (1, C, d)
    si = min(max(mm_len - offset, 0), x.shape[1])  # image rows in the chunk
    if si:
        x = torch.cat([_image_rows(params, batch["embeds"][:, :si]),
                       x[:, si:]], dim=1)
    P = cache["k_pages"].shape[2]
    rows = ll.chunk_rows(cfg, offset, x.shape[1], table, P)
    n_ctx = min((offset + x.shape[1] + P - 1) // P, table.shape[0])
    ctx = table[:n_ctx].long()
    for lp, kp, vp in zip(params.layers, cache["k_pages"], cache["v_pages"]):
        x = _block(lp, x, cfg, lambda p, h: ll.attn_prefill_chunk(
            p, h, cfg, offset, rows, ctx, kp, vp))
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    valid = int(batch["valid"])
    return ll.logits_last(params, x[:, valid - 1], cfg)


def decode_paged_fn(params: DenseLM, cache: Tree, batch: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """One batched token step (``transformer.py:226-246``), its products
    through ``ops.gemm_rows`` (an MoE block's routed experts through
    ``ops.gemm_rows_grouped``). Returns (B, V)."""
    positions = batch["positions"]
    table = batch["page_table"]
    mm = ops.gemm_rows
    x = ll.embed_lookup(params, batch["tokens"])          # (B, 1, d)
    rows = ll.decode_rows(cfg, positions, table, cache["k_pages"].shape[2])
    lengths = (positions + 1).to(torch.int32)
    for lp, kp, vp in zip(params.layers, cache["k_pages"], cache["v_pages"]):
        x = _block(lp, x, cfg, lambda p, h: ll.attn_decode_paged(
            p, h, cfg, rows, lengths, kp, vp, table, mm), mm,
            ops.gemm_rows_grouped)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg, mm)


def verify_paged_fn(params: DenseLM, cache: Tree, batch: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """Speculative verification (``transformer.py:249-272``): one pass over
    a W-token window, logits for every window position. The window folds
    into the batch of :func:`decode_paged_fn`: lane ``(b, j)`` decodes
    ``tokens[b, j]`` at position ``positions[b] + j`` through lane b's table
    row. Every folded lane writes its K/V in a layer before any attends, and
    lane j's length stops at its own position, so causality is exact; and
    each lane's arithmetic is plain decode's, so greedy speculation gives
    plain decode's tokens. Returns (B, W, V)."""
    tokens = batch["tokens"]                              # (B, W)
    B, W = tokens.shape
    fold = {
        "tokens": tokens.reshape(B * W, 1),
        "positions": (batch["positions"][:, None]
                      + torch.arange(W, device=tokens.device)).reshape(-1),
        "page_table": batch["page_table"].repeat_interleave(W, dim=0),
    }
    return decode_paged_fn(params, cache, fold, cfg).reshape(B, W, -1)


# ---------------------------------------------------------------------------
# Training: the loss over a layer-stacked f32 tree
# ---------------------------------------------------------------------------


class _LayerView:
    """One layer's weights as :func:`_block` reads them, for the loss:
    ``attn`` and ``mlp`` are namespaces of tensors, the ``cast`` leaves in
    bf16 (the reference's ``ll.cast`` at each use) and the others f32."""

    def __init__(self, attn: dict, mlp: dict):
        self.attn = SimpleNamespace(**attn)
        self.mlp = SimpleNamespace(**mlp)

    def ffn(self, h: torch.Tensor, cfg: ModelConfig, mm: ll.Matmul,
            grouped=None) -> torch.Tensor:
        return ll.mlp_forward(self.mlp, h, cfg, mm)


def _cast(t: torch.Tensor, spec: PSpec) -> torch.Tensor:
    return t.to(torch.bfloat16) if spec.cast else t


def _unstack(group: Tree, specs: dict):
    """A layer-stacked group of the f32 tree (nested dicts of ``(L, ...)``
    leaves) cut into layers: the per-layer tuples of its leaves' slices,
    one ``unbind`` a leaf (its backward stacks the layers' gradients at
    once), and ``view(leaves)``, the nested dict of one layer's slices, the
    ``cast`` ones in bf16."""
    paths = []

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], path + (k,))
            else:
                paths.append(path + (k,))

    def at(node, path):
        for k in path:
            node = node[k]
        return node

    walk(group, ())
    per_layer = list(zip(*(torch.unbind(at(group, p)) for p in paths)))

    def view(leaves) -> dict:
        out: dict = {}
        for path, t in zip(paths, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _cast(t, at(specs, path))
        return out

    return per_layer, view


@contextlib.contextmanager
def _recompute(ctx, backend: str):
    with ctx, ops.use_backend(backend):
        yield


def _remat(fn, cfg: ModelConfig, policy: str | None = None):
    """Wrap a layer function per ``cfg.remat_policy``, or ``policy`` where
    given (``transformer.py:93-101``): ``full`` recomputes the whole layer
    in the backward, ``dots`` keeps the matrix products' outputs and
    recomputes the rest, ``none`` keeps everything. The recompute runs
    under the kernel backend the forward ran under (``ops.use_backend``):
    autograd runs a CUDA backward on a thread of its own, which the scope
    does not reach."""
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    policy = policy or cfg.remat_policy
    if policy == "none":
        return fn

    def run(*args):
        backend = ops.current_backend()

        def contexts():
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
            if policy == "dots":
                fwd, rec = create_selective_checkpoint_contexts(
                    [torch.ops.aten.mm.default, torch.ops.aten.bmm.default])
            return fwd, _recompute(rec, backend)

        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=contexts)

    return run


def loss_fn(tree: Tree, batch: dict, cfg: ModelConfig):
    """The language-model loss of ``batch`` (``tokens``, ``labels`` (B, S)
    int, a VLM's ``embeds`` (B, n_image_tokens, VISION_D)) under the
    layer-stacked f32 tree ``tree`` (the reference's layout, ``transformer.
    py:119-124``). Every layer runs :func:`_block` over views of its slice
    of the stacked leaves, the ``cast`` ones in bf16, so autograd reaches
    the f32 leaves through the casts; each layer is rematerialized per
    ``cfg.remat_policy``. Returns (loss, {"ce", "z_loss", "tokens"})."""
    specs = build_specs(cfg)
    top = SimpleNamespace(**{k: _cast(v, specs[k]) for k, v in tree.items()
                             if k != "layers"})
    x = _residual_shard(_embed_inputs(top, cfg, batch), cfg)
    rows = ll.dense_rows(cfg, torch.arange(x.shape[1], device=x.device))
    per_layer, view = _unstack(tree["layers"], specs["layers"])

    def layer(x, *leaves):
        return _block(_LayerView(**view(leaves)), x, cfg,
                      lambda p, h: ll.attn_forward(p, h, cfg, rows)[0])

    body = _remat(layer, cfg)
    for leaves in per_layer:
        x = body(x, *leaves)
    x = ops.rmsnorm(x, tree["final_ln"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, -batch["labels"].shape[1]:]
    return ll.lm_loss(top, x, batch["labels"], cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A cell's inputs as meta tensors (``transformer.py:275-290``): a
    VLM's train and prefill cells add ``embeds`` (B, n_image_tokens,
    VISION_D), whose rows take part of the sequence, so its text is
    ``seq_len - n_image_tokens`` long."""
    def extra(cfg, shape):
        if cfg.family != "vlm" or shape.kind == "decode":
            return {}
        b = shape.global_batch
        return {"embeds": meta_tensor((b, cfg.n_image_tokens, VISION_D),
                                      torch.bfloat16)}

    out = standard_input_specs(cfg, shape, extra)
    if cfg.family == "vlm" and shape.kind != "decode":
        s_text = shape.seq_len - cfg.n_image_tokens
        b = shape.global_batch
        out["tokens"] = meta_tensor((b, s_text), torch.int32)
        if shape.kind == "train":
            out["labels"] = meta_tensor((b, s_text), torch.int32)
    return out


def make_model(cfg: ModelConfig) -> ModelFns:
    return ModelFns(
        cfg=cfg,
        param_specs=build_specs(cfg),
        build=functools.partial(DenseLM, cfg),
        cache_specs=functools.partial(cache_specs, cfg),
        prefill=functools.partial(prefill_fn, cfg=cfg),
        decode_step=functools.partial(decode_fn, cfg=cfg),
        paged_cache_specs=functools.partial(paged_cache_specs, cfg),
        prefill_chunk=functools.partial(prefill_chunk_fn, cfg=cfg),
        decode_paged=functools.partial(decode_paged_fn, cfg=cfg),
        verify_paged=functools.partial(verify_paged_fn, cfg=cfg),
        # VLM prompts chunk their image rows inline (positions < mm_len)
        paged_mm_inline=cfg.family == "vlm",
        loss=functools.partial(loss_fn, cfg=cfg),
        input_specs=functools.partial(input_specs, cfg),
    )
