"""Fault-tolerant training runner: checkpoint and restart, heartbeats,
simulated failures (port of ``repro/train/ft.py``; host code).

* every ``ckpt_every`` steps, and after the last, the state (parameters
  and optimizer state) is checkpointed atomically (``train/checkpoint.py``);
* a heartbeat file is written each step, for a supervisor to detect stalls;
* on a (re)start the runner restores the latest checkpoint and takes the
  data stream's position from the restored step: the pipeline
  (``data/tokens.py``) makes every batch a function of its step, so a
  restarted run continues on the same batches;
* ``failure_at`` raises :class:`SimulatedFailure` before that step, to
  test the path; :func:`run_with_restarts` relaunches after it.

With ``sharding`` (``train/loop.py``'s ``TrainSharding``, the step made
with it) the state is each rank's blocks: ``init_state`` returns them
(``TrainSharding.place_state``), a restore cuts them from the whole
checkpoint, and a save gathers the state whole on every rank, which the
mesh's first rank writes.  So a checkpoint of one mesh restores onto
another or onto one process.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.train import checkpoint

__all__ = ["FtConfig", "SimulatedFailure", "run_training",
           "run_with_restarts"]


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FtConfig:
    ckpt_dir: str
    total_steps: int
    ckpt_every: int = 50
    keep: int = 3
    heartbeat_path: str | None = None
    failure_at: int | None = None     # inject a crash before this step runs
    log_every: int = 10
    log_fn: Callable[[str], None] = print


def _heartbeat(cfg: FtConfig, step: int):
    if cfg.heartbeat_path:
        with open(cfg.heartbeat_path, "w") as f:
            f.write(f"{step} {time.time()}\n")


def _save(cfg: FtConfig, step: int, state: dict[str, Any],
          sharding: Any) -> None:
    if sharding is not None:
        state = sharding.gather_state(state)
        if sharding.ctx.mesh.get_rank() != int(sharding.ctx.mesh.mesh.min()):
            return
    checkpoint.save(cfg.ckpt_dir, step, state, keep=cfg.keep)


def run_training(*, init_state: Callable[[], dict[str, Any]],
                 train_step: Callable[..., tuple[Any, Any, dict]],
                 batch_at: Callable[[int], dict[str, np.ndarray]],
                 cfg: FtConfig, sharding: Any = None) -> dict[str, Any]:
    """Run (or resume) training to ``total_steps``.

    ``init_state() -> {"params", "opt_state"}`` builds fresh state (and the
    template a restore fills); ``batch_at(step)`` is the deterministic
    data pipeline.  Returns ``{"params", "opt_state", "step", "history"}``,
    history the loss of each step this call ran.
    """
    start = checkpoint.latest_step(cfg.ckpt_dir)
    if start is not None:
        state = checkpoint.restore(cfg.ckpt_dir, init_state(), start,
                                   sharding=sharding)
        cfg.log_fn(f"[ft] restored checkpoint at step {start}")
        step0 = start
    else:
        state = init_state()
        step0 = 0

    params, opt_state = state["params"], state["opt_state"]
    del state
    history: list[float] = []
    for step in range(step0, cfg.total_steps):
        if cfg.failure_at is not None and step == cfg.failure_at:
            raise SimulatedFailure(f"injected failure before step {step}")
        params, opt_state, metrics = train_step(params, opt_state,
                                                batch_at(step))
        _heartbeat(cfg, step)
        loss = float(metrics["loss"])
        history.append(loss)
        if step % cfg.log_every == 0:
            cfg.log_fn(f"[train] step={step} loss={loss:.4f} "
                       f"lr={float(metrics['lr']):.2e}")
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            _save(cfg, step + 1, {"params": params, "opt_state": opt_state},
                  sharding)
    return {"params": params, "opt_state": opt_state,
            "step": cfg.total_steps, "history": history}


def run_with_restarts(run: Callable[[], dict[str, Any]], *,
                      max_restarts: int = 3,
                      log_fn: Callable[[str], None] = print
                      ) -> dict[str, Any]:
    """Relaunch ``run`` after a :class:`SimulatedFailure`, up to
    ``max_restarts`` times.  ``run`` must resume (be built on
    :func:`run_training`), so a relaunch continues rather than starts
    over."""
    attempts = 0
    while True:
        try:
            return run()
        except SimulatedFailure as e:
            attempts += 1
            log_fn(f"[ft] failure: {e}; restart {attempts}/{max_restarts}")
            if attempts > max_restarts:
                raise
