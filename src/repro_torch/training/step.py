"""The train step: loss → grads → (compressed) reduce → clip → AdamW.

Ported from ``repro/training/step.py``. Gradients come from
``torch.autograd.grad`` over the f32 master leaves; with ``microbatches``
n > 1 the batch is cut along its leading dim, the gradients summed in f32
and divided by n (the loss likewise), and the last microbatch's aux kept,
as the reference's ``lax.scan`` does. The state's leaves are updated in
place (``optim/adamw.py`` says why).

A step runs under ``torch.use_deterministic_algorithms(True)``: beside the
hand-written backward kernels, which use no floating-point atomics, two of
torch's own CUDA backward ops accumulate with atomics by default, the
embedding gather's (``layers.embed_lookup``) and the loss's ``gather``;
deterministic mode gives both sorted, fixed-order kernels, and makes
cuBLAS deterministic, which needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
environment before CUDA starts (``launch/train.py`` sets it; torch raises
without it). So a step's result is the same bits on every run, which the
trainer's continuity (a restored run equal to an uninterrupted one) rests
on.

The step's randomness: ``state["rng"]``'s words seed a numpy
``SeedSequence`` that gives the next words and, with int8 compression, the
seed of the ``torch.Generator`` the rounding noise comes from.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.models.model_api import ModelFns, tree_leaves, tree_map
from repro_torch.optim import adamw_update
from repro_torch.parallel.collectives import compress_grads


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the scope."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def split_rng(words: np.ndarray) -> tuple[np.ndarray, int]:
    """The next ``rng`` words and a 64-bit seed for this step's noise."""
    w = np.random.SeedSequence([int(x) for x in words]).generate_state(
        4, np.uint32)
    return w[:2].copy(), (int(w[2]) << 32) | int(w[3])


def make_train_step(model: ModelFns, run: RunConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the params' device."""

    def one_micro(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss, aux = model.loss(live, batch)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                tree_map(lambda p: grads[id(p)], live))

    def train_step(state, batch):
        params = state["params"]
        rng, comp_seed = split_rng(state["rng"])
        dev = tree_leaves(params)[0].device
        with deterministic():
            n = run.microbatches
            if n > 1:
                b = next(iter(batch.values())).shape[0] // n
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = None
                for i in range(n):
                    mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                    loss_i, aux, g = one_micro(params, mb)
                    loss = loss + loss_i
                    if grads is None:
                        grads = g  # zeros + g, bit for bit
                    else:
                        for a, x in zip(tree_leaves(grads), tree_leaves(g)):
                            a.add_(x)
                        del g
                loss = loss / n
                for g in tree_leaves(grads):
                    g.div_(n)
            else:
                loss, aux, grads = one_micro(params, batch)
            gen = None
            if run.grad_compression != "none":
                gen = torch.Generator(device=dev).manual_seed(comp_seed)
            grads = compress_grads(grads, gen, run.grad_compression)
            new_params, new_opt, info = adamw_update(
                params, grads, state["opt"], run.optim)
        new_state = {
            "params": new_params,
            "opt": new_opt,
            "rng": rng,
            "data_step": np.asarray(int(state["data_step"]) + 1, np.int32),
        }
        metrics = {"loss": loss, **info, **aux}
        return new_state, metrics

    return train_step
