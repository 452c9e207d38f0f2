"""Token-choice top-k MoE decoders (granite-moe, deepseek-moe): the dense
and the paged serving paths.

Ported from ``repro/models/moe.py`` (its non-EP path: ``moe_mlp_forward_ep``
is expert parallelism over many devices), the training loss too
(:func:`loss_fn`). Leading dense layers (``first_k_dense``) come first, then
the MoE layers; the caches are layer-stacked over all of them in that order, as the
reference concatenates them (``moe.py:309-313``). The attention, the norms
and every entry point are the dense decoder's (``models/transformer.py``):
an MoE layer is a block whose ``ffn`` routes through the experts.

Dispatch is the reference's sort-based capacity scheme (``moe.py:196-254``):

- routing: f32 logits of the normalized bf16 ``h`` (``ops.moe_route``), a
  softmax, the top-k (a tie to the lower id) renormalised;
- capacity ``cap = max(8, min(ceil(T k capacity_factor / E), T))``, and
  ``max(cap, T)`` at ``S == 1``, so a decode or verify lane never drops;
  a prefill chunk's pad positions route and take capacity too;
- the (token, choice) pairs ordered by a stable argsort of their expert
  ids; a pair's rank within its expert follows from that order, and a pair
  ranked past ``cap`` is dropped;
- dispatch writes each kept pair's token into its ``(expert, rank)`` slot of
  a zeroed ``(E, cap, d)`` buffer (each kept slot gets one token; a dropped
  pair goes to a sink row past the buffer);
- the experts' SwiGLU: g and u in bf16, SiLU in f32 cast to bf16 times u,
  down in bf16;
- combine: each pair's output row times its weight cast to bf16, a token's
  k contributions added in ascending expert id (its pairs' order in the
  sorted list) into a bf16 row, rounding after each add, as the reference's
  scatter-add does (``tests/test_torch_moe.py`` holds this on the CPU); on
  the card a fixed loop, never ``index_add_``, whose atomics add in no
  fixed order; the shared experts' output added last.

On the paged decode step the routed experts' products go through
``ops.gemm_rows_grouped`` (one launch for all experts, rows independent of
the capacity and of the other experts, experts no lane chose skipped) and
every other product through ``ops.gemm_rows``; prefill, the dense engine
and training keep ``torch.matmul``/``torch.bmm``.

Training (:func:`moe_mlp_train`, :func:`loss_fn`) adds the reference's
Switch-style aux loss, ``E * sum_e mean_t(probs_e) * counts_e / (T k)``
(``moe.py:215-218``; the counts carry no gradient), and differentiates the
route through ``ops.moe_route`` (its backward kernel on the card). A
dropped pair gets no gradient, as the reference's ``where(keep, ...)``
gives none; both backwards of the dispatch and the combine are gathers and
a sort-based ``index_put`` under the step's deterministic mode: no
``index_add_``, no atomics.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.model_api import ModelFns, Params, PSpec, Tree


def moe_mlp_specs(cfg: ModelConfig, layers: int) -> dict:
    """``moe.py:38-55``. The router is read in f32 (``moe.py:210``): it is
    no ``cast`` leaf, so it stays f32."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    lead, lax_ = (layers,), ("layers",)
    specs = {
        "router": PSpec(lead + (d, E), lax_ + ("embed", "experts"),
                        init="small"),
        "wg": PSpec(lead + (E, d, f), lax_ + ("experts", "embed_in",
                                              "expert_mlp"), cast=True),
        "wu": PSpec(lead + (E, d, f), lax_ + ("experts", "embed_in",
                                              "expert_mlp"), cast=True),
        "wd": PSpec(lead + (E, f, d), lax_ + ("experts", "expert_mlp",
                                              "embed_out"), cast=True),
        "ln": PSpec(lead + (d,), lax_ + ("embed",), init="ones"),
    }
    if cfg.n_shared_experts:
        w = cfg.n_shared_experts * cfg.d_expert
        specs["shared"] = {k: v for k, v in
                           ll.mlp_specs(cfg, w, layers=layers).items()
                           if k != "ln"}
    return specs


def build_specs(cfg: ModelConfig) -> dict:
    n_moe = cfg.n_layers - cfg.first_k_dense
    specs = {
        **ll.embed_specs(cfg),
        "moe_layers": {
            "attn": ll.attn_specs(cfg, layers=n_moe),
            "mlp": moe_mlp_specs(cfg, layers=n_moe),
        },
    }
    if cfg.first_k_dense:
        specs["dense_layers"] = {
            "attn": ll.attn_specs(cfg, layers=cfg.first_k_dense),
            "mlp": ll.mlp_specs(cfg, cfg.d_ff_dense or cfg.d_ff,
                                layers=cfg.first_k_dense),
        }
    return specs


def _at(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a nested tree of layer-stacked leaves."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class MoeMLP(nn.Module):
    """One MoE layer's MLP: ``router`` (f32), the experts' ``wg``/``wu``/
    ``wd`` (E, ., .), ``ln``, and the shared experts (a SwiGLU) or None."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            if name != "shared":
                self.register_parameter(name, nn.Parameter(
                    t, requires_grad=False))
        self.shared = Params(**tensors["shared"]) \
            if "shared" in tensors else None


class MoeBlock(nn.Module):
    def __init__(self, attn: dict, mlp: dict):
        super().__init__()
        self.attn = Params(**attn)
        self.mlp = MoeMLP(mlp)

    def ffn(self, h: torch.Tensor, cfg: ModelConfig, mm: ll.Matmul,
            grouped=None) -> torch.Tensor:
        return moe_mlp_forward(self.mlp, h, cfg, mm, grouped)


class MoeLM(nn.Module):
    """Weights of an MoE decoder: embedding, ``layers`` (the leading dense
    :class:`transformer.Block` s, then one :class:`MoeBlock` per MoE layer,
    the caches' layer order), final norm, and the unembedding unless
    tied."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        for name, t in tree.items():
            if name not in ("moe_layers", "dense_layers"):
                self.register_parameter(name, nn.Parameter(
                    t, requires_grad=False))
        dense = [tf.Block(**_at(tree["dense_layers"], i))
                 for i in range(cfg.first_k_dense)]
        moe = [MoeBlock(**_at(tree["moe_layers"], i))
               for i in range(cfg.n_layers - cfg.first_k_dense)]
        self.layers = nn.ModuleList(dense + moe)


# ---------------------------------------------------------------------------
# The MoE MLP
# ---------------------------------------------------------------------------


def capacity(cfg: ModelConfig, T: int, S: int) -> int:
    """Slots per expert for ``T`` tokens of rows of ``S`` (``moe.py:
    221-228``): a decode or verify call (S == 1) never drops."""
    cap = int(math.ceil(T * cfg.moe_top_k * cfg.capacity_factor
                        / cfg.n_experts))
    cap = max(8, min(cap, T))
    return max(cap, T) if S == 1 else cap


def _bmm(buf: torch.Tensor, w: torch.Tensor, counts) -> torch.Tensor:
    return torch.bmm(buf, w)


def _expert_mlp(p: MoeMLP, buf: torch.Tensor, grouped, counts):
    """buf (E, C, d) -> (E, C, d) through each expert's SwiGLU
    (``moe.py:81-87``)."""
    g = grouped(buf, p.wg, counts)
    u = grouped(buf, p.wu, counts)
    h = F.silu(g.float()).to(g.dtype) * u
    return grouped(h, p.wd, counts)


def route(p: MoeMLP, xf: torch.Tensor, cfg: ModelConfig, S: int):
    """The sort-based dispatch plan of the tokens ``xf (T, d)``: per
    (token, choice) pair, token-major, its expert ``e`` (T k,), its weight
    (T, k) f32, its rank within its expert, whether it is kept; and the
    count of pairs per expert (E,) and the capacity."""
    return _plan(*ops.moe_route(xf, p.router, cfg.moe_top_k), cfg, S)


def _plan(weights: torch.Tensor, sel: torch.Tensor, cfg: ModelConfig,
          S: int):
    """:func:`route`'s plan from the router's ``weights`` and ``sel`` (T,
    k)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    T = sel.shape[0]
    e = sel.reshape(-1).long()
    # integer adds, exact in any order (``torch.bincount`` would read the
    # largest id back to the host first)
    counts = torch.zeros(E, dtype=torch.long, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))
    cap = capacity(cfg, T, S)
    order = torch.argsort(e, stable=True)
    starts = counts.cumsum(0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * k, device=e.device) - starts[e[order]]
    return e, weights, rank, rank < cap, counts, cap


def combine(contrib: torch.Tensor) -> torch.Tensor:
    """A token's contributions ``contrib (T, k, d)``, in the order the
    reference's scatter-add applies them, added into a zeroed row of their
    type, rounding after each add (``moe.py:250``): a fixed loop, so a
    token's sum depends on its own contributions alone."""
    y = torch.zeros_like(contrib[:, 0])
    for j in range(contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def _moe_mlp(p, x: torch.Tensor, cfg: ModelConfig, mm: ll.Matmul,
             grouped, with_probs: bool):
    """:func:`moe_mlp_forward`'s body. Returns (y (B, S, d), the dispatch
    plan's expert counts (E,), and with ``with_probs`` the router's softmax
    (T, E), else None)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, d)
    routed = ops.moe_route(xf, p.router, k, with_probs=with_probs)
    e, weights, rank, keep, counts, cap = _plan(routed[0], routed[1], cfg, S)
    probs = routed[2] if with_probs else None
    # dispatch: a kept pair into its (expert, rank) slot, a dropped one into
    # the sink row E * cap, which the buffer leaves out (each token's k
    # copies through ``expand``, whose backward is a sum, not index_add_)
    slot = torch.where(keep, e * cap + rank, E * cap)
    flat = torch.zeros(E * cap + 1, d, dtype=x.dtype, device=x.device)
    flat[slot] = xf[:, None].expand(T, k, d).reshape(T * k, d)
    buf = flat[:E * cap].view(E, cap, d)
    out = _expert_mlp(p, buf, grouped or _bmm, counts).reshape(E * cap, d)
    # combine: each pair's row (a dropped pair reads slot (e, cap - 1) with
    # weight 0, as the reference's clamped rank does) times its weight in
    # bf16, a token's pairs added in ascending expert id
    by_e = torch.argsort(e.view(T, k), dim=1)
    pair = (torch.arange(T, device=x.device)[:, None] * k + by_e).reshape(-1)
    rows = out[e[pair] * cap + rank[pair].clamp(max=cap - 1)]
    wt = torch.where(keep[pair], weights.reshape(-1)[pair], 0.0)
    y = combine((rows * wt.to(rows.dtype)[:, None]).view(T, k, d))
    if p.shared is not None:
        y = y + ll.mlp_forward(p.shared, xf, cfg, mm)
    return y.reshape(B, S, d), counts, probs


def moe_mlp_forward(p: MoeMLP, x: torch.Tensor, cfg: ModelConfig,
                    mm: ll.Matmul = torch.matmul,
                    grouped=None) -> torch.Tensor:
    """x (B, S, d), normalized -> (B, S, d) (``moe.py:196-254``, without
    the aux loss). ``grouped(buf, w, counts)`` is the routed experts'
    product (``ops.gemm_rows_grouped`` on the paged decode step; None for
    ``torch.bmm``), ``mm`` the shared experts'."""
    return _moe_mlp(p, x, cfg, mm, grouped, False)[0]


def moe_mlp_train(p, x: torch.Tensor,
                  cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The training form of :func:`moe_mlp_forward` (``moe.py:196-254``):
    the same output, every product ``torch.matmul``/``torch.bmm``, and the
    Switch-style aux loss ``E * sum_e mean_t(probs_e) * counts_e / (T k)``
    (``moe.py:215-218``), its counts without gradient. Returns (y, aux)."""
    y, counts, probs = _moe_mlp(p, x, cfg, torch.matmul, None, True)
    frac = counts.float() / (probs.shape[0] * cfg.moe_top_k)
    return y, cfg.n_experts * torch.sum(probs.mean(0) * frac)


# ---------------------------------------------------------------------------
# Training: the loss over a layer-stacked f32 tree
# ---------------------------------------------------------------------------


class _MoeLayerView(tf._LayerView):
    """One MoE layer's weights as :func:`transformer._block` reads them, for
    the loss (``transformer._LayerView``, the shared experts a namespace of
    their own or None); its ``ffn`` keeps the layer's aux loss in
    ``aux``."""

    def __init__(self, attn: dict, mlp: dict):
        super().__init__(attn, {k: v for k, v in mlp.items()
                                if k != "shared"})
        self.mlp.shared = SimpleNamespace(**mlp["shared"]) \
            if "shared" in mlp else None
        self.aux = None

    def ffn(self, h: torch.Tensor, cfg: ModelConfig, mm: ll.Matmul,
            grouped=None) -> torch.Tensor:
        y, self.aux = moe_mlp_train(self.mlp, h, cfg)
        return y


def loss_fn(tree: Tree, batch: dict, cfg: ModelConfig):
    """The loss of ``batch`` (``tokens``, ``labels`` (B, S) int) under the
    layer-stacked f32 tree ``tree`` (``moe.py:279-322``): the leading dense
    layers, then the MoE layers, each rematerialized per
    ``cfg.remat_policy`` (``transformer._remat``: the recompute routes
    under the forward's backend, and the router kernel is deterministic, so
    it picks the same experts), the final norm and ``ll.lm_loss``, plus
    ``cfg.router_aux_coef`` times the MoE layers' mean aux loss. Returns
    (loss, {"ce", "z_loss", "tokens", "router_aux"})."""
    specs = build_specs(cfg)
    groups = ("dense_layers", "moe_layers")
    top = SimpleNamespace(**{k: tf._cast(v, specs[k]) for k, v in tree.items()
                             if k not in groups})
    x = ll.embed_lookup(top, batch["tokens"])
    rows = ll.dense_rows(cfg, torch.arange(x.shape[1], device=x.device))

    def attend(p, h):
        return ll.attn_forward(p, h, cfg, rows)[0]

    def dense_layer(view, x, *leaves):
        return tf._block(tf._LayerView(**view(leaves)), x, cfg, attend)

    def moe_layer(view, x, *leaves):
        lp = _MoeLayerView(**view(leaves))
        return tf._block(lp, x, cfg, attend), lp.aux

    def stack(group, fn):
        per_layer, view = tf._unstack(tree[group], specs[group])
        return per_layer, tf._remat(functools.partial(fn, view), cfg)

    if "dense_layers" in tree:
        per_layer, body = stack("dense_layers", dense_layer)
        for leaves in per_layer:
            x = body(x, *leaves)
    per_layer, body = stack("moe_layers", moe_layer)
    auxs = []
    for leaves in per_layer:
        x, aux = body(x, *leaves)
        auxs.append(aux)
    x = ops.rmsnorm(x, tree["final_ln"], cfg.norm_eps)
    loss, info = ll.lm_loss(top, x, batch["labels"], cfg)
    aux = torch.stack(auxs).mean()
    info["router_aux"] = aux
    return loss + cfg.router_aux_coef * aux, info


def make_model(cfg: ModelConfig) -> ModelFns:
    return ModelFns(
        cfg=cfg,
        param_specs=build_specs(cfg),
        build=functools.partial(MoeLM, cfg),
        cache_specs=functools.partial(tf.cache_specs, cfg),
        prefill=functools.partial(tf.prefill_fn, cfg=cfg),
        decode_step=functools.partial(tf.decode_fn, cfg=cfg),
        paged_cache_specs=functools.partial(tf.paged_cache_specs, cfg),
        prefill_chunk=functools.partial(tf.prefill_chunk_fn, cfg=cfg),
        decode_paged=functools.partial(tf.decode_paged_fn, cfg=cfg),
        verify_paged=functools.partial(tf.verify_paged_fn, cfg=cfg),
        # a pure page-pool cache: prefix sharing, spill and speculation
        paged_state=False,
        loss=functools.partial(loss_fn, cfg=cfg),
    )
