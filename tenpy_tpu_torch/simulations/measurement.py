"""Measurement functions a simulation connects to its measurement event.

Port of ``tenpy_tpu/simulations/measurement.py``.  Each ``m_*`` function
takes ``(results, psi, model, simulation, **kwargs)`` and writes its
entries into ``results``; the simulation appends them, per measurement,
to ``results['measurements']``.  Everything here runs on the host state
(CPU torch blocks) and writes host values.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

__all__ = ['measurement_index', 'bond_dimension', 'bond_energies',
           'energy_MPO', 'entropy', 'onsite_expectation_value',
           'correlation_length', 'evolved_time', 'psi_method',
           'simulation_method', 'm_measurement_index', 'm_bond_dimension',
           'm_bond_energies', 'm_energy_MPO', 'm_entropy',
           'm_onsite_expectation_value', 'm_correlation_length',
           'm_evolved_time']


def m_measurement_index(results, psi, model, simulation,
                        key='measurement_index'):
    results[key] = len(simulation.results.get('measurements', {}).get(key,
                                                                      []))


def m_bond_dimension(results, psi, model, simulation, key='max_chi'):
    results[key] = max(psi.chi) if psi.chi else 1


def m_bond_energies(results, psi, model, simulation, key='bond_energies'):
    if not hasattr(model, 'H_bond'):
        return
    results[key] = model.bond_energies(psi)


def m_energy_MPO(results, psi, model, simulation, key='energy_MPO'):
    """``model.H_MPO.expectation_value(psi)``, as TeNPy: the full
    contraction for finite bc, the energy per site for infinite bc.
    ``tenpy_tpu`` contracts an environment with trivial boundaries for
    both, which for infinite bc is not the energy."""
    results[key] = model.H_MPO.expectation_value(psi)


def m_entropy(results, psi, model, simulation, key='entropy'):
    results[key] = psi.entanglement_entropy()


def m_onsite_expectation_value(results, psi, model, simulation, opname='Sz',
                               key=None):
    key = key or f'<{opname}>'
    try:
        results[key] = psi.expectation_value(opname)
    except (KeyError, AttributeError):
        logger.debug("op %r not defined on all sites; skipping", opname)


def m_correlation_length(results, psi, model, simulation,
                         key='correlation_length'):
    if psi.finite:
        return
    results[key] = psi.correlation_length()


def m_evolved_time(results, psi, model, simulation, key='evolved_time'):
    engine = getattr(simulation, 'engine', None)
    if engine is not None and hasattr(engine, 'evolved_time'):
        results[key] = engine.evolved_time


def psi_method(results, psi, model, simulation, method, key=None,
               **kwargs):
    """A method of ``psi`` as a measurement, its value under ``key``
    (default the method's name).  ``method`` ``'wrap name'`` is TeNPy's
    form of the same: the value of ``psi.name`` under ``results_key``."""
    if method.startswith('wrap '):
        method = method[len('wrap '):].strip()
        key = kwargs.pop('results_key', key)
    results[key or method] = getattr(psi, method)(**kwargs)


def simulation_method(results, psi, model, simulation, method, key=None,
                      **kwargs):
    """A method of the simulation as a measurement (an ``m_*`` method
    writes its own keys)."""
    func = getattr(simulation, method)
    if method.startswith('m_'):
        return func(results, psi, model, simulation, **kwargs)
    results[key or method] = func(**kwargs)


# the short aliases of the reference's names (m_* is the canonical form)
measurement_index = m_measurement_index
bond_dimension = m_bond_dimension
bond_energies = m_bond_energies
energy_MPO = m_energy_MPO
entropy = m_entropy
onsite_expectation_value = m_onsite_expectation_value
correlation_length = m_correlation_length
evolved_time = m_evolved_time
