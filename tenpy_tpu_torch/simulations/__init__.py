"""Simulations from options (the port of ``tenpy_tpu.simulations``): the
ground-state search, its measurements and post-processing access."""
from . import measurement, post_processing, simulation
from .simulation import (Simulation, GroundStateSearch, init_simulation,
                         run_simulation, resume_from_checkpoint,
                         run_seq_simulations)

__all__ = ['simulation', 'measurement', 'post_processing', 'Simulation',
           'GroundStateSearch', 'init_simulation', 'run_simulation',
           'resume_from_checkpoint', 'run_seq_simulations']
