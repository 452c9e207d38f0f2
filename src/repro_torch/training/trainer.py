"""The fault-tolerant trainer: a training job as an ad hoc cloud guest.

Ported from ``repro/training/trainer.py`` over the port's ``core/``,
``checkpoint/serializer.py`` and ``checkpoint/store.py``. The job's guest
is a :class:`TrainingGuest` whose snapshot is the serialized
:data:`TrainState`, copied to the host. The :class:`AdHocTrainer` stands up
a simulated host fleet (server + clients + stores), binds the job to it,
and interleaves real optimizer steps with the protocol daemons on a
simulated clock (1 train step = ``step_time_s`` of cloud time). Failures —
injected by step index — kill the executing host; the server restores the
latest snapshot on the most reliable receiver and training continues.

Because the data pipeline is stateless-in-the-cursor, snapshots carry
``data_step`` + RNG, and a step gives the same bits on every run (its
kernels use no floating-point atomics, and it runs in torch's
deterministic mode, ``training/step.py``), a restored run is *bit-exact*
with an uninterrupted run at equal effective steps, on the card too
(``tests/test_torch_trainer.py``, ``chip_smoke.py``'s ``phase_train``).
The counters (effective, executed, recomputed steps, restores, restarts)
are the reference's for the same schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.serializer import deserialize_tree, serialize_tree
from repro_torch.checkpoint.store import SnapshotStore
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.availability import GUEST_PROBE_INTERVAL_S, POLL_INTERVAL_S
from repro_torch.core.client import AdHocClient
from repro_torch.core.server import AdHocServer, JobState
from repro_torch.core.simulation import EventLoop, SimClock
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.models import get_model
from repro_torch.models.model_api import ModelFns, tree_map
from repro_torch.training.state import init_train_state
from repro_torch.training.step import make_train_step


def _stand_in(leaf):
    """A tensor leaf's shape, type and device without its memory (a 0-d
    tensor expanded); a numpy leaf as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.new_empty(()).expand(leaf.shape)
    return leaf


class TrainingGuest:
    """GuestRuntime implementation wrapping a real training task on
    ``device``."""

    def __init__(
        self,
        guest_id: str,
        job_id: str,
        *,
        model: ModelFns,
        run: RunConfig,
        dataset: SyntheticDataset,
        total_steps: int,
        train_step,
        device: torch.device,
    ):
        self.guest_id = guest_id
        self.job_id = job_id
        self.model = model
        self.run = run
        self.dataset = dataset
        self.total_steps = total_steps
        self._train_step = train_step
        self.device = device
        self.state: Any = None
        self.running = False
        self.failed = False
        self.suspended = False
        self.losses: list[tuple[int, float]] = []

    # ---- GuestRuntime --------------------------------------------------
    def start(self, payload: Any, now: float) -> None:
        self.running = True
        self.failed = False
        if self.state is None:
            self.state = init_train_state(self.model, self.run.seed,
                                          self.device)

    def healthy(self) -> bool:
        return self.running and not self.failed

    def progress(self) -> float:
        if self.state is None:
            return 0.0
        return float(np.asarray(self.state["data_step"]))

    def complete(self) -> bool:
        return self.progress() >= self.total_steps

    def snapshot(self) -> bytes:
        """The state copied to the host and serialized (the reference's
        blob format)."""
        return serialize_tree(self.state)

    def restore(self, blob: bytes) -> None:
        like = self.state if self.state is not None \
            else init_train_state(self.model, self.run.seed, self.device)
        # stand-ins of like's shapes, types and devices, so that the old
        # state's device memory goes before the blob's leaves arrive
        like = tree_map(_stand_in, like)
        self.state = None
        self.state = deserialize_tree(blob, like)
        self.running = True
        self.failed = False

    def stop(self) -> None:
        self.running = False

    # ---- work -----------------------------------------------------------
    def run_step(self) -> float | None:
        """One real optimizer step. Returns the loss (None if idle)."""
        if not self.healthy() or self.suspended or self.complete():
            return None
        step_idx = int(self.progress())
        batch = {
            k: torch.from_numpy(v).to(self.device)
            for k, v in self.dataset.batch(step_idx).items()
        }
        self.state, metrics = self._train_step(self.state, batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            # NaN/Inf = guest failure (caught by the 10 s probe)
            self.failed = True
            return loss
        self.losses.append((step_idx, loss))
        return loss


@dataclass
class TrainerReport:
    completed: bool
    effective_steps: int
    executed_steps: int
    recomputed_steps: int
    restores: int
    restarts_from_zero: int
    losses: list[tuple[int, float]]
    final_state: Any
    host_of_step: list[str] = field(default_factory=list)


class AdHocTrainer:
    """Run one training job to completion on a simulated ad hoc fleet."""

    def __init__(
        self,
        cfg: ModelConfig,
        run: RunConfig,
        *,
        n_hosts: int = 4,
        total_steps: int = 20,
        seq_len: int = 64,
        global_batch: int = 8,
        step_time_s: float = 30.0,
        fail_at_steps: dict[int, str] | None = None,
        recovery_s: float = 600.0,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run = run
        self.total_steps = total_steps
        self.step_time_s = step_time_s
        self.fail_at_steps = dict(fail_at_steps or {})
        self.recovery_s = recovery_s

        self.model = get_model(cfg)
        self.dataset = SyntheticDataset(cfg, seq_len, global_batch, run.seed)
        self._train_step = make_train_step(self.model, run)

        self.loop = EventLoop(SimClock())
        self.clock = self.loop.clock
        self.server = AdHocServer(
            snapshot_target_failure=run.snapshot_target_failure,
            max_snapshot_receivers=run.max_snapshot_receivers,
        )
        self.server.create_cloudlet("train", cfg.arch_id)
        self.host_ids = [f"host{i:03d}" for i in range(n_hosts)]
        self.stores = {h: SnapshotStore() for h in self.host_ids}
        self.clients: dict[str, AdHocClient] = {}
        self.guests: dict[str, TrainingGuest] = {}
        for i, h in enumerate(self.host_ids):
            self.clients[h] = AdHocClient(
                h,
                self.server,
                guest_factory=self._make_guest,
                peer_stores=self.stores,
                local_store=self.stores[h],
                snapshot_target_failure=run.snapshot_target_failure,
                max_snapshot_receivers=run.max_snapshot_receivers,
            )
            self.server.register_host(h, 0.0, cloudlets=["train"])
            self.loop.every(
                POLL_INTERVAL_S,
                (lambda c: lambda: c.poll(self.clock.now()))(self.clients[h]),
                first_in=POLL_INTERVAL_S * (i + 1) / n_hosts,
            )
            self.loop.every(
                GUEST_PROBE_INTERVAL_S,
                (lambda c: lambda: c.probe_guest(self.clock.now()))(
                    self.clients[h]
                ),
                first_in=GUEST_PROBE_INTERVAL_S * (i + 1) / n_hosts,
            )
        self.loop.every(10.0, lambda: self.server.tick(self.clock.now()))

    def _make_guest(self, guest_id: str, job_id: str) -> TrainingGuest:
        g = TrainingGuest(
            guest_id,
            job_id,
            model=self.model,
            run=self.run,
            dataset=self.dataset,
            total_steps=self.total_steps,
            train_step=self._train_step,
            device=self.device,
        )
        self.guests[guest_id] = g
        return g

    # ------------------------------------------------------------------ run
    def _active(self) -> tuple[AdHocClient, TrainingGuest] | None:
        for c in self.clients.values():
            if c.up and c.guest is not None and c.guest.healthy():
                return c, c.guest
        return None

    def run_to_completion(self, max_wall_steps: int | None = None
                          ) -> TrainerReport:
        job_id = self.server.submit_job(
            "train", self.total_steps, self.clock.now()
        )
        executed = 0
        losses: list[tuple[int, float]] = []
        host_of_step: list[str] = []
        budget = max_wall_steps or self.total_steps * 8
        snapshot_every = max(1, self.run.snapshot_interval_steps)
        while budget > 0:
            budget -= 1
            job = self.server.jobs[job_id]
            if job.state in (JobState.COMPLETED, JobState.FAILED):
                break
            active = self._active()
            if active is None:
                # nobody is executing: let daemons detect/reschedule
                self.loop.run_for(self.step_time_s)
                continue
            client, guest = active
            step_idx = int(guest.progress())
            # scripted failure injection (deterministic by step index)
            if self.fail_at_steps.get(step_idx) == client.host_id:
                self.fail_at_steps.pop(step_idx)
                client.go_down(self.clock.now())
                self.loop.schedule(
                    self.recovery_s,
                    (lambda c: lambda: c.come_up(self.clock.now()))(client),
                )
                continue
            loss = guest.run_step()
            if loss is not None:
                executed += 1
                losses.append((step_idx, loss))
                host_of_step.append(client.host_id)
                if (step_idx + 1) % snapshot_every == 0:
                    client.snapshot_guest(self.clock.now())
            client.maybe_report_completion(self.clock.now())
            self.loop.run_for(self.step_time_s)

        job = self.server.jobs[job_id]
        final_guest = max(
            (g for g in self.guests.values() if g.state is not None),
            key=lambda g: g.progress(),
            default=None,
        )
        effective = int(final_guest.progress()) if final_guest else 0
        return TrainerReport(
            completed=job.state == JobState.COMPLETED,
            effective_steps=effective,
            executed_steps=executed,
            recomputed_steps=executed - effective,
            restores=job.restores,
            restarts_from_zero=job.restarts_from_zero,
            losses=losses,
            final_state=final_guest.state if final_guest else None,
            host_of_step=host_of_step,
        )
