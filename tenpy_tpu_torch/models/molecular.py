r"""The molecular (quantum chemistry) Hamiltonian as an MPO model.

Port of ``tenpy_tpu/models/molecular.py``:

.. math ::
    H = \sum_{\sigma, ij} h_{ij} c^\dagger_{\sigma i} c_{\sigma j}
        + \tfrac{1}{2} \sum_{\sigma\tau, ijkl} h_{ijkl}
          c^\dagger_{\sigma i} c^\dagger_{\tau k} c_{\tau l} c_{\sigma j}
        + \text{constant}

The molecular orbitals are the sites of a one-cell lattice with ``norb``
sites; the MPOGraph compiles the all-to-all terms, with the
Jordan-Wigner strings inserted.  The integral tensors are parameters
(no integrals file is read).
"""

from __future__ import annotations

import itertools

import numpy as np

from .lattice import Lattice
from .model import CouplingMPOModel
from ..networks.site import SpinHalfFermionSite

__all__ = ['MolecularModel']


class MolecularModel(CouplingMPOModel):
    r"""Spin-1/2 fermions in ``norb`` molecular orbitals, from one- and
    two-body integrals.

    Options: ``one_body_tensor`` (norb, norb), required;
    ``two_body_tensor`` (norb,)*4 (zeros); ``constant`` (0.); ``cons_N``
    ('N'), ``cons_Sz`` ('Sz').  The tensors may be any array-like.
    """

    def __init__(self, model_params):
        obt = model_params['one_body_tensor'] \
            if 'one_body_tensor' in model_params else None
        if obt is None:
            raise ValueError("required parameter one_body_tensor missing")
        self.one_body_tensor = np.asarray(obt)
        self.norb = self.one_body_tensor.shape[0]
        CouplingMPOModel.__init__(self, model_params)

    def init_sites(self, params):
        return SpinHalfFermionSite(cons_N=params.get('cons_N', 'N'),
                                   cons_Sz=params.get('cons_Sz', 'Sz'))

    def init_lattice(self, params):
        site = self.init_sites(params)
        basis = np.array([[self.norb, 0.], [0., 1.]])
        pos = np.array([[i, 0.] for i in range(self.norb)])
        return Lattice([1, 1], [site] * self.norb, basis=basis,
                       positions=pos)

    def init_terms(self, params):
        params.touch('one_body_tensor')
        norb = self.norb
        h1 = self.one_body_tensor
        tbt = np.asarray(params.get('two_body_tensor',
                                    np.zeros((norb, norb, norb, norb))))
        constant = params.get('constant', 0., 'real')
        for p in range(norb):
            h2 = tbt[p, p, p, p]
            self.add_onsite(h1[p, p], p, 'Ntot')
            self.add_onsite(h2, p, 'Ntot')
            self.add_onsite(-0.5 * h2, p, 'Nu Nu')
            self.add_onsite(-0.5 * h2, p, 'Cdu Cd Cdd Cu')
            self.add_onsite(-0.5 * h2, p, 'Cdd Cu Cdu Cd')
            self.add_onsite(-0.5 * h2, p, 'Nd Nd')
            self.add_onsite(constant / norb, p, 'Id')
        for p, q in itertools.combinations(range(norb), 2):
            self._add_one_body(h1[p, q], p, q, flag_hc=True)
            for i, j, k, ell in [(p, p, q, q), (p, q, p, q), (p, q, q, p)]:
                self._add_two_body(0.5 * tbt[i, j, k, ell], i, j, k, ell,
                                   flag_hc=True)
        pairs = list(itertools.combinations_with_replacement(range(norb), 2))
        for p, s in pairs:
            for q, r in pairs:
                values, counts = np.unique([p, q, r, s], return_counts=True)
                if len(values) in (1, 2) and len(set(counts)) == 1:
                    continue    # added above
                indices = [(p, q, r, s)]
                if p != s:
                    indices.append((s, q, r, p))
                if q != r:
                    indices.append((p, r, q, s))
                for idx, (i, j, k, ell) in enumerate(indices):
                    self._add_two_body(
                        0.5 * tbt[i, j, k, ell], i, j, k, ell,
                        flag_hc=bool(not idx and i != ell and j != k))

    def _add_one_body(self, coeff, i, j, flag_hc=False):
        dx0 = np.zeros(2, int)
        self.add_coupling(coeff, i, 'Cdu', j, 'Cu', dx0, plus_hc=flag_hc)
        self.add_coupling(coeff, i, 'Cdd', j, 'Cd', dx0, plus_hc=flag_hc)

    def _add_two_body(self, coeff, i, j, k, ell, flag_hc=False):
        dx0 = np.zeros(2, int)
        for op_i, op_k, op_l, op_j in [('Cdu', 'Cdu', 'Cu', 'Cu'),
                                       ('Cdu', 'Cdd', 'Cd', 'Cu'),
                                       ('Cdd', 'Cdu', 'Cu', 'Cd'),
                                       ('Cdd', 'Cdd', 'Cd', 'Cd')]:
            self.add_multi_coupling(
                coeff, [(op_i, dx0, i), (op_k, dx0, k), (op_l, dx0, ell),
                        (op_j, dx0, j)], plus_hc=flag_hc)
