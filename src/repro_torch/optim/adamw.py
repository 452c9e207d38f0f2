"""AdamW with warmup+cosine schedule and global-norm clipping, from scratch.

Ported from ``repro/optim/adamw.py``. Optimizer state mirrors the parameter
tree (nested dicts of tensors): ``mu`` and ``nu`` f32 like their
parameters, ``step`` a 0-d int32 numpy array held on the host. The math is
the reference's, in f32, leaf by leaf in its order (sorted keys, as
``jax.tree`` flattens a dict); ``info = {"grad_norm", "lr"}``.

One difference: :func:`adamw_update` updates ``params``, ``mu`` and ``nu``
in place. At full width a second copy of the three would not fit beside
the gradients (smollm-360m's f32 state is 4.3 GB, a qwen3-8b cut to 8
layers' 44.6 GB with its gradients); the reference's jitted step donates
them for the same reason. The clip scales ``grads`` in place too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config import OptimConfig
from repro_torch.models.model_api import Tree, tree_leaves, tree_map


def adamw_init(params: Tree) -> Tree:
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "step": np.zeros((), np.int32),
    }


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: OptimConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` as a 0-d f32 tensor (on the host),
    computed in f32 as the reference computes it."""
    step = _f32(int(step))
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.learning_rate * warm
    frac = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares, in f32; a 0-d tensor on the leaves' device."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(l.float())) for l in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float,
                        norm: torch.Tensor) -> Tree:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-9))``, in
    place; returns the tree."""
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(tree):
        g.mul_(scale.to(g.dtype))
    return tree


def adamw_update(params: Tree, grads: Tree, opt_state: Tree,
                 cfg: OptimConfig) -> tuple[Tree, Tree, dict]:
    """One AdamW step, in place on ``params``, ``opt_state["mu"]``,
    ``opt_state["nu"]`` and ``grads`` (clipped). Returns (params, opt_state,
    info), the first two the same trees."""
    step = int(opt_state["step"]) + 1
    norm = global_norm(grads)
    clip_by_global_norm(grads, cfg.grad_clip_norm, norm)
    lr = lr_schedule(cfg, step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    # the bias corrections and the rate in f32, as the reference's
    c1 = float(1.0 - _f32(b1) ** _f32(step))
    c2 = float(1.0 - _f32(b2) ** _f32(step))
    lr_f = float(lr)
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["mu"]),
                              tree_leaves(opt_state["nu"])):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            upd = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
            upd.add_(wd * p)
            p.sub_(lr_f * upd)
    opt_state["step"] = np.asarray(step, np.int32)
    return params, opt_state, {"grad_norm": norm, "lr": lr}
