"""JutulCase: a complete simulation case specification.

Port of the JAX package's ``core/case.py`` (reference ``JutulCase``,
src/core_types/core_types.jl:946-1045): model + timestep vector + forces
(constant or per step) + initial state + parameters (+ arbitrary input
data). States and parameters stay host data (numpy), as the setup
functions build them; the simulator and the adjoint place them on their
device. Indexing subsets the schedule, as in the reference.
"""

from __future__ import annotations

import numpy as np


class JutulCase:
    def __init__(self, model, dt=None, forces=None, state0=None,
                 parameters=None, input_data=None, start_date=None):
        from ..models.setup import setup_parameters, setup_state

        self.model = model
        if dt is None:
            dt = [1.0]
        self.dt = np.atleast_1d(np.asarray(dt, dtype=np.float64))
        if isinstance(forces, list) and len(forces) != len(self.dt):
            raise ValueError(
                f"forces list length {len(forces)} != number of steps "
                f"{len(self.dt)}")
        self.forces = forces
        self.state0 = state0 if state0 is not None else setup_state(model)
        self.parameters = (parameters if parameters is not None
                           else setup_parameters(model))
        self.input_data = input_data
        self.start_date = start_date

    def __len__(self) -> int:
        return len(self.dt)

    def __getitem__(self, ix) -> "JutulCase":
        """Subset the schedule (reference core_types.jl:1010)."""
        if isinstance(ix, int):
            ix = slice(ix, ix + 1)
        forces = self.forces[ix] if isinstance(self.forces, list) \
            else self.forces
        return JutulCase(self.model, self.dt[ix], forces, state0=self.state0,
                         parameters=self.parameters,
                         input_data=self.input_data,
                         start_date=self.start_date)

    def total_time(self) -> float:
        return float(np.sum(self.dt))

    def __repr__(self) -> str:  # pragma: no cover
        return (f"JutulCase({len(self.dt)} steps, total time "
                f"{self.total_time():.3g})")
