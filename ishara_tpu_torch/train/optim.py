"""Optimizers and schedules (port of ``ishara_tpu/train/optim.py``).

Reference contracts:

* ``lrfn``: exponential warm-up ``lr_max * 2^-(warmup - epoch)`` (or the
  ``"log"`` method, ``lr_max * 0.1^(warmup - epoch)``), then half-cosine decay
  to 0, stepped **per epoch**.
* weight decay coupled to the learning rate: ``wd = lr * wd_ratio``, on
  **every** parameter.
* Optimizer: RectifiedAdam(sma threshold 4) -- Lookahead is applied at the
  train-state level -- or Adam with a one-cycle schedule.

:class:`Optimizer` is the reference's optax chain written out: clip by the
global norm -> the RAdam or Adam direction -> ``+ wd_ratio * p`` ->
``* -lr(count)``, in that order. It is functional, as optax is: ``update``
returns the parameter updates and a new state and changes nothing, so the
caller can keep the old state when a batch turns out non-finite. The learning
rate reads the state's own ``schedule_count`` -- updates made, not steps
attempted. Everything is tensor arithmetic on the state's device: no host
sync.
"""

from __future__ import annotations

import math

import torch

from ..config import TrainConfig


def _count(step) -> torch.Tensor:
    return torch.as_tensor(step)


def lrfn_schedule(lr_max: float, warmup_epochs: int, num_epochs: int,
                  steps_per_epoch: int, num_cycles: float = 0.5,
                  warmup_method: str = "exp"):
    """Per-epoch ``lrfn`` as a per-step schedule: ``schedule(count)`` takes
    an integer (tensor) count and returns a float32 tensor."""

    def schedule(step):
        step = _count(step)
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        e = epoch.to(torch.float32)
        base = 0.10 if warmup_method == "log" else 0.5
        warm = lr_max * torch.pow(base, warmup_epochs - e)
        progress = (e - warmup_epochs) / max(1, num_epochs - warmup_epochs)
        cos = torch.clamp(
            0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress)),
            min=0.0) * lr_max
        return torch.where(epoch < warmup_epochs, warm, cos)

    return schedule


def onecycle_schedule(lr_max: float, total_steps: int,
                      pct_start: float = 0.3, div_factor: float = 25.0,
                      final_div_factor: float = 1e4):
    """The torch-path one-cycle schedule: cosine from ``lr_max / 25`` up to
    ``lr_max`` over the first 30% of ``total_steps``, then cosine down to
    ``lr_max / 25e4`` (optax's ``cosine_onecycle_schedule``)."""
    if total_steps <= 0:
        raise ValueError("a one-cycle schedule needs a positive total_steps")
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    init = lr_max / div_factor
    values = [init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor)]

    def schedule(step):
        c = _count(step).to(torch.float32)
        out = torch.zeros_like(c)
        for i in range(2):
            size = bounds[i + 1] - bounds[i]
            pct = (c - bounds[i]) / size if size else torch.zeros_like(c)
            v = values[i + 1] + (values[i] - values[i + 1]) / 2.0 \
                * (1.0 + torch.cos(math.pi * pct))
            inside = (c >= bounds[i]) & (c < bounds[i + 1])
            out = torch.where(inside, v, out)
        return torch.where(c >= bounds[-1],
                           torch.full_like(c, values[-1]), out)

    return schedule


class Optimizer:
    """clip by global norm -> RAdam / Adam direction -> ``+ wd_ratio * p``
    -> ``* -lr(schedule_count)`` on one flat float32 parameter tensor."""

    def __init__(self, schedule, rectified: bool, clip_norm: float,
                 wd_ratio: float, threshold: float = 5.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.rectified = schedule, rectified
        self.clip_norm, self.wd_ratio = clip_norm, wd_ratio
        self.threshold, self.b1, self.b2, self.eps = threshold, b1, b2, eps

    def init(self, params: torch.Tensor) -> dict:
        """``count`` (moment updates), ``mu``, ``nu``, ``schedule_count``."""
        zero = torch.zeros((), dtype=torch.int32, device=params.device)
        return {"count": zero, "mu": torch.zeros_like(params),
                "nu": torch.zeros_like(params),
                "schedule_count": zero.clone()}

    @torch.no_grad()
    def update(self, grads: torch.Tensor, state: dict, params: torch.Tensor,
               grad_norm: torch.Tensor | None = None):
        """(updates, new state) for ``grads``; ``params + updates`` are the
        new parameters. ``grad_norm`` is the global norm of ``grads`` when
        the caller already has it."""
        b1, b2 = self.b1, self.b2
        g_norm = grads.norm() if grad_norm is None else grad_norm
        # as optax.clip_by_global_norm: no epsilon in the division
        g = torch.where(g_norm < self.clip_norm, grads,
                        grads / g_norm * self.clip_norm)
        mu = (1.0 - b1) * g + b1 * state["mu"]
        nu = (1.0 - b2) * (g * g) + b2 * state["nu"]
        count = state["count"] + 1
        c = count.to(torch.float32)
        b1t, b2t = torch.pow(b1, c), torch.pow(b2, c)
        mu_hat = mu / (1.0 - b1t)
        nu_hat = nu / (1.0 - b2t)
        adam = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.rectified:
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - 2.0 * c * b2t / (1.0 - b2t)
            # below the threshold the rectifier is undefined (and unused)
            r = torch.sqrt(torch.clamp(
                (ro - 4.0) * (ro - 2.0) * ro_inf
                / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro), min=0.0))
            direction = torch.where(ro >= self.threshold, r * adam, mu_hat)
        else:
            direction = adam
        direction = direction + self.wd_ratio * params
        step_size = -self.schedule(state["schedule_count"])
        new_state = {"count": count, "mu": mu, "nu": nu,
                     "schedule_count": state["schedule_count"] + 1}
        return step_size.to(direction.dtype) * direction, new_state


def make_optimizer(cfg: TrainConfig):
    """Returns (tx, schedule). ``tx`` excludes Lookahead (train-state
    level)."""
    total_steps = cfg.num_epochs * cfg.steps_per_epoch
    if cfg.optimizer in ("radam_lookahead", "radam"):
        schedule = lrfn_schedule(cfg.lr_max, cfg.warmup_epochs,
                                 cfg.num_epochs, cfg.steps_per_epoch)
        tx = Optimizer(schedule, True, cfg.grad_clip_norm, cfg.wd_ratio,
                       threshold=cfg.radam_sma_threshold)
    elif cfg.optimizer == "adamw":
        schedule = onecycle_schedule(cfg.lr_max, total_steps)
        tx = Optimizer(schedule, False, cfg.grad_clip_norm, cfg.wd_ratio)
    else:
        raise ValueError(cfg.optimizer)
    return tx, schedule
