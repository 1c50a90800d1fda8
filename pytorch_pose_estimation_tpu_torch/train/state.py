"""Train state: the model, its optimizer and the LR schedule.

Counterpart of pytorch_pose_estimation_tpu/train/state.py.  The JAX state
is an immutable pytree that each step replaces; here the model and the
optimizer are updated in place and the state only groups them.  ``step``
is the number of optimizer updates (the optimizer's count), as
``TrainState.step`` is in the JAX package.  ``generators`` are the train
step's random generators (``Trainer.fit`` sets them): their states are
saved with the rest, so a resumed fit continues the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from ..optim import ChainOptimizer, Schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ChainOptimizer
    schedule: Schedule
    generators: tuple = ()

    @property
    def step(self) -> int:
        return self.optimizer.count

    def state_dict(self) -> dict:
        out = {"step": self.step, "model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict()}
        if self.generators:
            out["rng"] = [g.get_state() for g in self.generators]
        return out

    def load_state_dict(self, state: dict) -> None:
        """The model, the optimizer and, where both sides have them, the
        generators' states."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.generators and "rng" in state:
            for g, s in zip(self.generators, state["rng"], strict=True):
                g.set_state(s)
        if self.step != int(state["step"]):
            raise ValueError(f"checkpoint step {state['step']} disagrees "
                             f"with its optimizer count {self.step}")
