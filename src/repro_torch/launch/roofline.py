"""The H100 roofline: the card's peaks, a kernel call's least time, and a
cell's terms (``repro/launch/roofline.py``, for the port's card).

Peaks of one H100 SXM (80 GB HBM3), each from NVIDIA's H100 datasheet or
the Hopper white paper:

- ``PEAK_FLOPS_BF16`` 989e12 FLOP/s: dense bf16 on the tensor cores
  (datasheet; 1,979 with sparsity, which nothing here uses);
- ``PEAK_FLOPS_F32`` 67e12 FLOP/s: f32 on the CUDA cores (datasheet);
- ``HBM_BW`` 3.35e12 B/s: HBM3 (datasheet);
- ``PEAK_EXPS`` exponentials a second on the special-function units: 16 an
  SM a clock (4 a sub-partition, white paper) on 132 SMs at 1.98 GHz (the
  boost clock of the white paper's SXM5 table);
- ``NVLINK_BW`` 450e9 B/s: NVLink 4's 900 GB/s, half each way (datasheet),
  for the collective term.

Three terms, in seconds, per (arch x shape x mesh), as the reference's:

    compute    = the operations' least time, per chip
    memory     = bytes_per_chip / HBM_BW
    collective = collective_bytes_per_chip / NVLINK_BW

The compute term of a meta pass (``launch/counter.py``) is the sum over
its calls of each call's least time on its units: products by their
operands' type (bf16 at ``PEAK_FLOPS_BF16``, f32 at ``PEAK_FLOPS_F32``) and
a kernel's :class:`~repro_torch.kernels._cost.Cost` through
:func:`ops_seconds` (its operations against its exponentials, the larger).
The materialized elastic cell runs sharded serving on a ``DeviceMesh``,
but the meta pass counts no collectives yet (ROADMAP item 16b), so the
collective bytes are none.

Not ported: the reference's HLO parsers (``parse_collective_bytes``,
``analyze_collectives``, ``calibrate_cost_semantics``) read the text of a
compiled XLA module, which the port never produces.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels._cost import Cost

PEAK_FLOPS_BF16 = 989e12       # dense bf16, tensor cores
PEAK_FLOPS_F32 = 67e12         # f32, CUDA cores
HBM_BW = 3.35e12               # bytes/s, HBM3
SMS = 132                      # SMs of the H100 SXM
PEAK_EXPS = 16 * SMS * 1.98e9  # exponentials/s: 16 an SM a clock, 1.98 GHz
NVLINK_BW = 450e9              # bytes/s a direction, NVLink 4

RATES = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}


def ops_seconds(cost: Cost) -> float:
    """A call's operations' least time (the larger of its FLOPs on their
    units and its exponentials on the special-function units)."""
    return max(cost.flops / RATES[cost.unit], cost.exps / PEAK_EXPS)


def bound(cost: Cost) -> dict:
    """The least time of one call: its bytes over HBM's rate against its
    operations over their units' peak (:func:`ops_seconds`)."""
    t_bytes = cost.bytes / HBM_BW
    t_ops = ops_seconds(cost)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: dict
    model_flops: float
    compute_s_per_chip: float

    @property
    def flops_global(self) -> float:
        return self.flops_per_chip * self.chips

    @property
    def t_compute(self) -> float:
        return self.compute_s_per_chip

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / NVLINK_BW

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """The largest term: the step's least time."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste indicator."""
        if self.flops_global == 0:
            return 0.0
        return self.model_flops / self.flops_global

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        compute: t_useful_compute / max(all terms)."""
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS_BF16
        t_step = self.t_bound
        return t_useful / t_step if t_step > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "flops_global": self.flops_global,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "compute_s_per_chip": self.compute_s_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train / 2·N·D per generated-token batch
    (N = active params; D = tokens processed)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


def terms_from_artifact(art: dict, cfg, shape) -> RooflineTerms:
    """A dry-run record's terms (``launch/dryrun.py``). Its ``collectives``
    is None until the meta pass counts collectives (item 16b): no
    collective bytes."""
    coll = art.get("collectives") or {}
    return RooflineTerms(
        arch=art["arch"],
        shape=art["shape"],
        mesh=art["mesh"],
        chips=art["chips"],
        flops_per_chip=art["flops_per_device"],
        bytes_per_chip=art["bytes_per_device"],
        collective_bytes_per_chip=float(sum(coll.values())),
        collective_breakdown=coll,
        model_flops=model_flops_for(cfg, shape),
        compute_s_per_chip=art["compute_s_per_device"],
    )
