"""Train state: AdamW with the reference's step-decayed learning rate
(mirrors ddsp_svc_tpu/train/state.py ``make_lr_schedule``,
``create_train_state``, ``param_count``).

The optimizer is torch's AdamW (b1 0.9, b2 0.999 unless given, eps 1e-8,
decoupled weight decay on every parameter, as optax ``adamw``). optax evaluates the
schedule at its step count *before* incrementing it, so update k (0-based)
runs at ``lr * gamma ** (k // decay_step)``; ``TrainState.apply_gradients``
sets that rate before each step. On resume every count starts at the
resumed step (JAX fast-forwards optax's count leaves), so the rate and
AdamW's bias correction continue from there, with zero moments unless the
checkpoint carries the optimizer state.

optax applies the decay as p - lr (m^ / (sqrt(v^) + eps) + wd p), torch as
p (1 - lr wd) - lr m^ / (sqrt(v^) + eps): equal in exact arithmetic, they
round differently (a few f32 ulps of p per step).

``opt_state_to_optax`` / ``restore_opt_state`` map the optimizer state to
and from the tree ``train/checkpoint.py`` writes for optax's chain:
``{'0': {'0': {'count', 'mu', 'nu'}, '1': {}, '2': {'count'}}}`` with mu and
nu in the JAX param layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.jax_params import moments_params, moments_state_dict


def make_lr_schedule(lr: float, decay_step: int | None, gamma: float | None):
    """step -> learning rate (StepLR: ``lr * gamma ** (step // decay_step)``)."""
    if not decay_step or not gamma or gamma == 1.0:
        return lambda step: float(lr)
    return lambda step: float(lr) * float(gamma) ** (step // int(decay_step))


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedule: object
    step: int = 0

    def lr(self) -> float:
        return self.schedule(self.step)

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at this step's
        rate; the step count advances."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()
        self.optimizer.step()
        self.step += 1


def create_train_state(model: torch.nn.Module, lr: float = 5e-4,
                       weight_decay: float = 0.0, decay_step: int | None = None,
                       gamma: float | None = None, start_step: int = 0,
                       betas: tuple[float, float] = (0.9, 0.999)) -> TrainState:
    """AdamW over ``model``'s parameters (``betas`` optax's b1 and b2: the
    model trainer's defaults, or the vocoder recipe's (0.8, 0.99))."""
    schedule = make_lr_schedule(lr, decay_step, gamma)
    optimizer = torch.optim.AdamW(model.parameters(), lr=schedule(start_step),
                                  betas=tuple(betas), eps=1e-8,
                                  weight_decay=weight_decay)
    if start_step:
        for p in model.parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(start_step)),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
    return TrainState(model, optimizer, schedule, int(start_step))


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def opt_state_to_optax(state: TrainState, model_args) -> dict:
    """AdamW's state -> optax's chain state dict (JAX layout)."""
    names = dict(state.model.named_parameters())
    mu, nu = {}, {}
    for name, p in names.items():
        st = state.optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    count = np.asarray(state.step, np.int32)
    return {"0": {"0": {"count": count, "mu": moments_params(model_args, mu),
                        "nu": moments_params(model_args, nu)},
                  "1": {}, "2": {"count": count.copy()}}}


def restore_opt_state(state: TrainState, model_args, loaded) -> bool:
    """Load optax's chain state into AdamW. A tree that does not match (an
    optimizer chain changed between runs, another model) leaves the state
    as it is, with a warning, as the JAX ``restore_opt_state`` does."""
    try:
        adam = loaded["0"]["0"]
        count = int(np.asarray(adam["count"]))
        mu = moments_state_dict(model_args, adam["mu"])
        nu = moments_state_dict(model_args, adam["nu"])
        new = {}
        for name, p in state.model.named_parameters():
            m, v = (torch.as_tensor(np.asarray(t[name], np.float32)) for t in (mu, nu))
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"{name}: {tuple(m.shape)} vs {tuple(p.shape)}")
            new[p] = {"step": torch.tensor(float(count)),
                      "exp_avg": m.to(p.device).clone(),
                      "exp_avg_sq": v.to(p.device).clone()}
    except Exception as e:  # structure mismatch: keep the fresh state
        print(f" [!] opt_state restore skipped ({type(e).__name__}: {str(e)[:120]})")
        return False
    state.optimizer.state.clear()
    state.optimizer.state.update(new)
    return True


def adam_moments(state: TrainState) -> tuple[int, dict, dict]:
    """(count, mu, nu) of AdamW's state by parameter name (zeros where a
    parameter has no state yet)."""
    mu, nu = {}, {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    return state.step, mu, nu


def load_adam_moments(state: TrainState, count: int, mu: dict, nu: dict) -> None:
    """Set AdamW's state from (count, mu, nu) by parameter name (numpy);
    raises on a missing or mis-shaped moment."""
    new = {}
    for name, p in state.model.named_parameters():
        m, v = (torch.as_tensor(np.asarray(t[name], np.float32)) for t in (mu, nu))
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"{name}: {tuple(m.shape)} vs {tuple(p.shape)}")
        new[p] = {"step": torch.tensor(float(count)),
                  "exp_avg": m.to(p.device).clone(),
                  "exp_avg_sq": v.to(p.device).clone()}
    state.optimizer.state.clear()
    state.optimizer.state.update(new)
    state.step = int(count)
