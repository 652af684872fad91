"""PyTorch/CUDA port of ``tenpy_tpu``: TeNPy's tensor networks on an NVIDIA
GPU.

The package mirrors ``tenpy_tpu``'s module layout (``linalg``,
``algorithms``, ``networks``, ``models``, ``tools``, ``simulations``) but
imports ``torch`` and never ``jax``.  Every packed tensordot is one launch
of a hand-written CUDA kernel of ``csrc/packed_contract.cu`` when its
tensors live on a CUDA device; on the CPU the same wrapper takes its plain
PyTorch version.  The entry points (``pack``, ``DeviceSweepEngine``,
``device_ramp``, ``DeviceTEBDEngine``, ``dmrg.run``, the simulations) put
their device work on the card unless the caller passes ``device='cpu'``.

A run starts from a model (``models``) and an MPS (``networks.mps``); the
host-side work (charge gauge, MPO, environments, the host DMRG engine's
sweeps) runs on CPU torch blocks (``linalg.np_conserved``) and the heavy
parts go to the device.  TeNPy's command line runs too:
``python -m tenpy_tpu_torch params.yml`` (:func:`console_main`).
"""

__version__ = '0.1.0'


def apply_overrides(options, overrides):
    """Set each ``'key=value'`` of ``overrides`` in the nested dict
    ``options`` at its dotted key, as ``-o`` does: the value is read as a
    python literal where it is one, else kept as a string."""
    import ast
    from .tools.misc import set_recursive
    for override in overrides:
        key, _, value = override.partition('=')
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        set_recursive(options, key, value, insert_dicts=True)
    return options


def console_main(args=None):
    """The command line: run the simulation of YAML parameter files.

    ``python -m tenpy_tpu_torch params.yml [more.yml ...] [-o key=value]
    [-i module] [--RAM]``: the files are merged (later ones win), each
    ``-o`` sets a dotted key (its value read as a python literal where it
    is one, e.g. ``-o algorithm_params.trunc_params.chi_max=256``), ``-i``
    imports a module that defines further classes, ``--RAM`` prints the
    memory estimate and stops; a ``sequential`` entry runs
    :func:`~tenpy_tpu_torch.simulations.simulation.run_seq_simulations`.
    ``device`` (a key, default 'cuda') says where the engines run:
    ``-o device=cpu`` for the CPU."""
    import argparse
    import importlib
    from .tools.misc import merge_recursive
    from .tools.params import load_yaml_with_py_eval
    from .simulations.simulation import estimate_simulation_RAM, \
        run_seq_simulations, run_simulation

    parser = argparse.ArgumentParser(
        prog='tenpy_tpu_torch',
        description="Run a tensor-network simulation from YAML parameter "
                    "files.")
    parser.add_argument('parameter_files', nargs='+',
                        help="YAML files; several are merged (later wins)")
    parser.add_argument('-o', '--option', action='append', default=[],
                        metavar='KEY=VALUE',
                        help="override options by dotted keys, e.g. "
                             "-o algorithm_params.trunc_params.chi_max=256")
    parser.add_argument('-i', '--import-module', action='append',
                        default=[],
                        help="import custom module(s) defining subclasses")
    parser.add_argument('--RAM', action='store_true',
                        help="estimate memory usage and exit")
    args = parser.parse_args(args)

    for mod in args.import_module:
        importlib.import_module(mod)
    configs = [load_yaml_with_py_eval(fn) for fn in args.parameter_files]
    options = merge_recursive(*configs, conflict='last') \
        if len(configs) > 1 else configs[0]
    apply_overrides(options, args.option)
    sim_class = options.pop('simulation_class', 'GroundStateSearch')
    if args.RAM:
        ram = estimate_simulation_RAM(simulation_class=sim_class, **options)
        print(f"estimated RAM: {ram:.1f} MB")
        return 0
    if 'sequential' in options:
        run_seq_simulations(options.pop('sequential'),
                            simulation_class=sim_class, **options)
    else:
        run_simulation(simulation_class=sim_class, **options)
    return 0
