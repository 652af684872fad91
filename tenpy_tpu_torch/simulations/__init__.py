"""Simulations from options (the port of ``tenpy_tpu.simulations``): the
ground-state search, the real-time evolution and the dynamical
correlations and spectral functions, their measurements and
post-processing."""
from . import measurement, post_processing, simulation, time_evolution
from .simulation import (Simulation, GroundStateSearch, RealTimeEvolution,
                         init_simulation, run_simulation,
                         resume_from_checkpoint, run_seq_simulations)
from .time_evolution import (TimeDependentCorrelation,
                             TimeDependentCorrelationEvolveBraKet,
                             SpectralSimulation,
                             SpectralSimulationEvolveBraKet)

__all__ = ['simulation', 'measurement', 'post_processing', 'time_evolution',
           'Simulation', 'GroundStateSearch', 'RealTimeEvolution',
           'TimeDependentCorrelation', 'TimeDependentCorrelationEvolveBraKet',
           'SpectralSimulation', 'SpectralSimulationEvolveBraKet',
           'init_simulation', 'run_simulation', 'resume_from_checkpoint',
           'run_seq_simulations']
