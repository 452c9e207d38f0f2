"""Where a recurrent family's first-step gradient under the kernels parts
from the plain step's, on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/train_gate_swap.py [--arch zamba2-1.2b] [--layers N]
        [--seeds 0 1] [--no-forced] [--tile-checks]

For each seed, the first train step (init seed s, batch s, B 2, S 2048,
published widths, ``--layers`` of the arch's depth, all by default) under
these variants, each from the same initial state:

- ``kernel`` and ``plain``: every kernel, no kernel;
- ``plain+K``: the plain versions but kernel ``K`` (forward and backward);
- ``plain+K_fwd`` (K the SSD or flash attention): the plain versions but
  K's forward kernel, its gradient by autograd through K's plain version;
- controls of rounding alone: ``P_ulp1``, the base path ``P`` with one bf16
  ulp added to one embedding value (the first token's first), and
  ``P_ulp_all``, every embedding value one ulp up or down at random.

Each variant's leaf shares (``chip_smoke._leaf_shares``, a layer-stacked
leaf layer by layer) against its base (``plain``, or ``P`` for a control):
the worst leaf, the five worst, the median. One ``READ`` line a variant.

Unless ``--no-forced``: the kernel step's backward kernels on the model's
own activations. Every backward kernel call of that step is kept
(``chip_smoke._KeptBackward``) and held by ``chip_smoke._forced_backward``
(each call rerun against a plain version, per tile); beside it, the decay
each SSD call saw (the least cumulated dt*A within a chunk) and flash's
gradients against autograd through the plain f32 attention, for the
kernel and for ``chip_smoke._flash_bwd_rounded`` (the kernel's rounding
points in plain torch). One ``FORCED`` line a kernel.

With ``--tile-checks``, ``chip_smoke.check_ssd_bwd`` and
``check_scan_bwd`` (their mild and initial-decay cases) first.

Everything also goes to ``build/train_gate_swap.json``.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as c  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG first)
import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as dk  # noqa: E402

KERNELS = ("rmsnorm", "flash_attention", "ssd", "selective_scan")
_PLAIN = ops._plain
_SSD = ops.ssd


class _KernelFwdPlainBwd(torch.autograd.Function):
    """The SSD's forward kernel; its gradient by autograd through the
    plain SSD, recomputed from the same inputs (h0 zero)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, C, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return dk.ssd(x, dt, A, Bm, C, D, None, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dhT):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, hT = ref.ssd(*ins, None, chunk=ctx.chunk)
            outs, gs = zip(*[(o, g) for o, g in ((y, dy), (hT, dhT))
                             if g is not None])
            grads = torch.autograd.grad(outs, ins, gs)
        return (*grads, None)


def _ssd_fwd_only(x, dt, A, Bm, C, D, h0=None, *, chunk=256):
    assert h0 is None, "the loss runs the SSD from a zero state"
    return _KernelFwdPlainBwd.apply(x, dt, A, Bm, C, D, chunk)


class _AttnKernelFwdPlainBwd(torch.autograd.Function):
    """Flash attention's forward kernel; its gradient by autograd through
    the plain attention, recomputed from the same inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset = causal, q_offset
        return fk.flash_attention(q, k, v, causal=causal, q_offset=q_offset)

    @staticmethod
    def backward(ctx, dout):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            grads = torch.autograd.grad(ref.attention(
                *ins, causal=ctx.causal, q_offset=ctx.q_offset), ins, dout)
        return (*grads, None, None)


def _attn_fwd_only(q, k, v, *, causal=True, q_offset=0):
    return _AttnKernelFwdPlainBwd.apply(q, k, v, causal, q_offset)


_ATTN = ops.attention


def _variant(kernels: set, fwd_only: str | None = None) -> None:
    """Route the kernels of ``kernels`` to their kernels, the rest to the
    plain versions (``ops._plain``); with ``fwd_only`` ("ssd" or
    "flash_attention"), that op through its forward kernel and the plain
    version's gradient."""

    def plain(x, name):
        if name in kernels:
            return _PLAIN(x, name)
        ops.plain_calls[name] += 1
        return True

    ops._plain = plain
    ops.ssd = _ssd_fwd_only if fwd_only == "ssd" else _SSD
    ops.attention = (_attn_fwd_only if fwd_only == "flash_attention"
                     else _ATTN)


def _shares(got, want) -> dict:
    shares = {n: max(v) for n, v in c._leaf_shares(got, want).items()}
    order = sorted(shares, key=shares.get, reverse=True)
    return {"worst_leaf": order[0], "share": shares[order[0]],
            "top5": {n: shares[n] for n in order[:5]},
            "median_leaf_share": shares[order[len(order) // 2]],
            "all": shares}


def _forced(kept) -> dict:
    """``chip_smoke._forced_backward`` on the kept calls (it raises where a
    call is off its limits), and beside it: the decay each SSD call saw,
    and flash's dq, dk, dv against autograd through the plain f32
    attention, for the kernel and for ``chip_smoke._flash_bwd_rounded``."""
    out = c._forced_backward(kept)
    ssd = out.setdefault("ssd", {})
    for a, kw in kept.calls["ssd"]:
        dt, A, ch = a[1], a[2], kw["chunk"]
        S = dt.shape[1]
        l = torch.nn.functional.pad(dt.float() * A, (0, 0, 0, -S % ch))
        l = l.reshape(dt.shape[0], -1, ch, dt.shape[2]).cumsum(2)
        ssd["least_cum_dtA_in_a_chunk"] = min(
            ssd.get("least_cum_dtA_in_a_chunk", 0.0), float(l.min()))
        ssd["mean_dt_max"] = max(ssd.get("mean_dt_max", 0.0),
                                 float(dt.float().mean()))
    flash = out.setdefault("flash_attention", {})
    for a, kw in kept.calls["flash_attention"]:
        q, k, v, _, dout, _ = a
        got = kept.orig["flash_attention"](*a, **kw)
        rounded = c._flash_bwd_rounded(*a, **kw)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.attention(*ins, **kw), ins, dout)
        for n, g, e, w in zip(("dq", "dk", "dv"), got, rounded, want):
            for key, x in ((n + "_vs_plain_f32", g),
                           (n + "_rounded_vs_plain_f32", e)):
                flash[key] = max(flash.get(key, 0.0), c._tile_share(x, w))
    return out


def main() -> int:
    from dataclasses import replace

    from repro_torch.config import RunConfig
    from repro_torch.configs import get
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models import get_model
    from repro_torch.models.model_api import tree_map
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import make_train_step

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--no-forced", action="store_true")
    ap.add_argument("--tile-checks", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": c.phase_device()}
    c.phase_build()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)

    def save():
        (out_dir / "train_gate_swap.json").write_text(json.dumps(report))

    if args.tile_checks:
        gen = torch.Generator(device="cuda").manual_seed(24)
        report["tile_checks"] = {"ssd": c.check_ssd_bwd(gen, {}),
                                 "scan": c.check_scan_bwd(gen, {})}
        for k, rows in report["tile_checks"].items():
            print("TILES", k, json.dumps(rows[1]), flush=True)
        save()
    full = get(args.arch)
    cfg = full if args.layers is None else replace(full, n_layers=args.layers)
    model = get_model(cfg)
    step = make_train_step(model, RunConfig(arch=cfg.arch_id))
    path = set(KERNELS)
    variants = [("plain", set(), "plain"), ("kernel", path, "plain")]
    variants += [(f"plain+{k}", {k}, "plain") for k in KERNELS
                 if k in c.TRAIN_PATH[cfg.arch_id]]
    variants += [(f"plain+{k}_fwd", set(), "plain")
                 for k in ("ssd", "flash_attention")
                 if k in c.TRAIN_PATH[cfg.arch_id]]
    for base, ks in (("plain", set()), ("kernel", path)):
        variants += [(f"{base}_ulp1", ks, base), (f"{base}_ulp_all", ks, base)]
    report["reads"] = []
    for seed in args.seeds:
        data = SyntheticDataset(cfg, 2048, 2, seed)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(seed).items()}
        token = int(batch["tokens"][0, 0])
        bases = {}
        for name, ks, base in variants:
            t0 = time.time()
            state = init_train_state(model, seed, "cuda")
            emb = state["params"]["embedding"]
            if name.endswith("_ulp1"):
                emb[token, 0] *= 1 + 2 ** -7
            elif name.endswith("_ulp_all"):
                g = torch.Generator(device="cuda").manual_seed(seed)
                sign = torch.randint(0, 2, emb.shape, generator=g,
                                     device="cuda") * 2 - 1
                emb.mul_(1 + sign * 2.0 ** -7)
            _variant(ks, fwd_only=name[6:-4] if name.endswith("_fwd")
                     else None)
            forced = (name == "kernel" and seed == args.seeds[0]
                      and not args.no_forced)
            try:
                if forced:
                    with c._KeptBackward() as stash:
                        state, m = step(state, batch)
                else:
                    state, m = step(state, batch)
            finally:
                _variant(path)
            mu = tree_map(torch.clone, state["opt"]["mu"])
            del state
            read = {"seed": seed, "variant": name, "n_layers": cfg.n_layers,
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
            if name in ("kernel", "plain"):
                bases[name] = mu
            if name != "plain":
                read["vs"] = base
                read.update(_shares(mu, bases[base]))
            if name not in ("kernel", "plain"):
                del mu
            read["seconds"] = time.time() - t0
            report["reads"].append(read)
            print("READ", json.dumps({k: v for k, v in read.items()
                                      if k != "all"}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            if forced:
                t0 = time.time()
                report["forced"] = _forced(stash)
                report["forced"]["seconds"] = time.time() - t0
                del stash
                gc.collect()
                torch.cuda.empty_cache()
                for kind, v in report["forced"].items():
                    print("FORCED", kind, json.dumps(v), flush=True)
            save()
        del bases
        gc.collect()
        torch.cuda.empty_cache()
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
