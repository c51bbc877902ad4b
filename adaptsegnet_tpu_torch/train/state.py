"""The port's train state: G, D1, D2, the Warper, the optimizers, the step.

Counterpart of adaptsegnet_tpu/train/state.py (`TrainState` with
GeneratorState / DiscriminatorState / WarperState). Modules and optimizers
are updated in place. The Warper has no optimizer: the reference never
optimises it, only its live statistics move. `state_dict()` /
`load_state_dict()` carry the full state (weights, the optimizer states, the
Warper's statistics, step) for exact resume with torch.save, where the
reference keeps only weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from adaptsegnet_tpu_torch.train.optim import set_poly_lr


@dataclass
class Schedule:
    """The poly schedules of G and the Ds (train/config.py names)."""
    learning_rate: float = 2.5e-4
    learning_rate_D: float = 1e-4
    num_steps: int = 250_000
    power: float = 0.9


@dataclass
class TrainState:
    model: nn.Module
    g_opt: torch.optim.Optimizer
    schedule: Schedule
    d1: nn.Module | None = None
    d2: nn.Module | None = None
    d1_opt: torch.optim.Optimizer | None = None
    d2_opt: torch.optim.Optimizer | None = None
    warper: nn.Module | None = None
    step: int = 0

    def set_lrs(self) -> None:
        """The poly LRs of this step, for every optimizer."""
        s = self.schedule
        set_poly_lr(self.g_opt, s.learning_rate, self.step, s.num_steps, s.power)
        for opt in (self.d1_opt, self.d2_opt):
            if opt is not None:
                set_poly_lr(opt, s.learning_rate_D, self.step, s.num_steps,
                            s.power)

    def _parts(self):
        return {"model": self.model, "g_opt": self.g_opt, "d1": self.d1,
                "d2": self.d2, "d1_opt": self.d1_opt, "d2_opt": self.d2_opt,
                "warper": self.warper}

    def state_dict(self) -> dict:
        sd = {k: v.state_dict() for k, v in self._parts().items()
              if v is not None}
        sd["step"] = self.step
        return sd

    def load_state_dict(self, sd: dict) -> None:
        for k, v in self._parts().items():
            if v is not None:
                v.load_state_dict(sd[k])
        self.step = int(sd["step"])
