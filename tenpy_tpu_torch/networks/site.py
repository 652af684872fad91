r"""Local Hilbert spaces: :class:`Site`, :class:`SpinHalfSite`,
:class:`SpinSite`, :class:`FermionSite` and :class:`SpinHalfFermionSite`.

Port of ``Site``, ``SpinHalfSite``, ``SpinSite``, ``FermionSite`` and
``SpinHalfFermionSite`` from
``tenpy_tpu/networks/site.py``, with the same state order, operator names,
charges and Jordan-Wigner bookkeeping, so models built on them give the
same MPO.  Operators are :class:`~tenpy_tpu_torch.linalg.np_conserved.Array`
s with legs ``['p', 'p*']``.
"""

from __future__ import annotations

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.charges import ChargeInfo, LegCharge
from ..tools.misc import inverse_permutation

__all__ = ['Site', 'SpinHalfSite', 'SpinSite', 'FermionSite',
           'SpinHalfFermionSite']


class Site:
    """A local Hilbert space: physical leg charges and named operators.

    Parameters
    ----------
    leg : LegCharge
        Charges of the physical basis states.
    state_labels : None | list of str
        Optional names of the basis states.
    sort_charge : bool
        Permute the local basis so that the leg is sorted by charge.
    **site_ops :
        Operators (dense matrices) added with :meth:`add_op`.

    Attributes
    ----------
    leg : LegCharge
    state_labels : dict str -> int
    opnames : set
    need_JW_string : set
        Names of the operators that need a Jordan-Wigner string.
    hc_ops : dict str -> str
        Operator name -> name of its hermitian conjugate.
    perm : ndarray
        Permutation of the original basis applied by the charge sort.
    """

    def __init__(self, leg, state_labels=None, sort_charge=True, **site_ops):
        self.leg = leg
        self.state_labels = {}
        if state_labels is not None:
            for i, l in enumerate(state_labels):
                if l is not None:
                    self.state_labels[str(l)] = i
        self.opnames = set()
        self.need_JW_string = {'JW'}
        self.hc_ops = {}
        self.used_sort_charge = False
        self.perm = np.arange(leg.ind_len)
        self.charge_to_JW_parity = None
        self.add_op('Id', np.eye(leg.ind_len), hc='Id')
        for name, op in site_ops.items():
            self.add_op(name, op)
        if 'JW' not in self.opnames:
            self.add_op('JW', np.eye(leg.ind_len), hc='JW')
        if sort_charge:
            self.sort_charge()

    @property
    def dim(self):
        return self.leg.ind_len

    def __repr__(self):
        return f"<Site d={self.dim}, ops={sorted(self.opnames)}>"

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The instance dict in the dict layouts (sets as sorted lists),
        as the reference library's ``Site``."""
        from ..tools.io import ATTR_FORMAT
        type_repr = hdf5_saver.save_dict_content(
            {k: (sorted(v) if isinstance(v, set) else v)
             for k, v in self.__dict__.items()}, h5gr, subpath)
        h5gr.attrs[ATTR_FORMAT] = type_repr

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        from ..tools.io import ATTR_FORMAT
        obj = cls.__new__(cls)
        hdf5_loader.memorize_load(h5gr, obj)
        data = hdf5_loader.load_dict(h5gr, hdf5_loader.get_attr(
            h5gr, ATTR_FORMAT), subpath)
        for k in ('opnames', 'need_JW_string'):
            if k in data:
                data[k] = set(data[k])
        obj.__dict__.update(data)
        return obj

    # -------------------------------------------------------------------- ops
    def add_op(self, name, op, need_JW=False, hc=None, permute_dense=None):
        """Add an on-site operator (a dense matrix or an Array).

        ``hc``: name of its hermitian conjugate (detected if None; False
        disables)."""
        if not name.isidentifier():
            raise ValueError(f"invalid operator name {name!r}")
        if name in self.opnames:
            raise ValueError(f"operator {name!r} already exists")
        if hasattr(self, name):
            raise ValueError(f"operator name {name!r} shadows an attribute")
        if isinstance(op, npc.Array):
            op = op.copy(deep=False)
            op.iset_leg_labels(['p', 'p*'])
        else:
            op = np.asarray(op)
            if op.shape != (self.dim, self.dim):
                raise ValueError(f"wrong operator shape {op.shape}")
            if permute_dense is None:
                permute_dense = self.used_sort_charge
            if permute_dense:
                op = op[np.ix_(self.perm, self.perm)]
            op = npc.Array.from_ndarray(op, [self.leg, self.leg.conj()],
                                        labels=['p', 'p*'])
        setattr(self, name, op)
        self.opnames.add(name)
        if need_JW:
            self.need_JW_string.add(name)
        if hc is None:
            hc = self._auto_detect_hc(name, op)
        if hc:
            self.hc_ops[hc] = name
            self.hc_ops[name] = hc

    def _auto_detect_hc(self, name, op):
        """An existing operator that is the hermitian conjugate of ``op``."""
        dagger = op.conj().itranspose([1, 0])
        dagger.iset_leg_labels(['p', 'p*'])
        if dagger.qtotal == op.qtotal:
            if npc.norm(dagger - op) < 1e-14 * max(npc.norm(op), 1e-10):
                return name
        for other in self.opnames:
            other_op = getattr(self, other)
            if other_op.qtotal == dagger.qtotal and \
                    other_op.dtype == dagger.dtype:
                try:
                    if npc.norm(dagger - other_op) < \
                            1e-14 * max(npc.norm(op), 1e-10):
                        return other
                except ValueError:
                    continue
        return None

    def change_charge(self, new_leg_charge, permute=None):
        """Change the charges of the leg (and so of every operator)."""
        old_ops = {name: getattr(self, name).to_numpy()
                   for name in self.opnames}
        need_JW = set(self.need_JW_string)
        hc_ops = dict(self.hc_ops)
        labels = dict(self.state_labels)
        if permute is not None:
            permute = np.asarray(permute, np.intp)
            inv = inverse_permutation(permute)
            labels = {lab: int(inv[i]) for lab, i in labels.items()}
            old_ops = {name: op[np.ix_(permute, permute)]
                       for name, op in old_ops.items()}
            self.perm = self.perm[permute]
        self.leg = new_leg_charge
        for name in list(self.opnames):
            delattr(self, name)
        self.opnames = set()
        self.hc_ops = {}
        self.need_JW_string = {'JW'}
        self.state_labels = labels
        for name, op in old_ops.items():
            self.add_op(name, op, need_JW=(name in need_JW),
                        hc=hc_ops.get(name, False) or None,
                        permute_dense=False)

    def sort_charge(self, bunch=True):
        """Sort the physical leg by charge, permuting the local basis."""
        if self.leg.is_sorted() and self.leg.is_bunched():
            return np.arange(self.dim)
        perm_flat, leg_sorted = self.leg.sort(bunch=bunch)
        self.used_sort_charge = True
        self.change_charge(leg_sorted, perm_flat)
        return perm_flat

    def state_index(self, label):
        if isinstance(label, (int, np.integer)):
            return int(label)
        try:
            return self.state_labels[str(label)]
        except KeyError:
            raise KeyError(f"unknown state label {label!r}; known: "
                           f"{sorted(self.state_labels)}") from None

    def valid_opname(self, name):
        return all(op in self.opnames for op in str(name).split())

    def get_op(self, name):
        """Operator by name; space-separated names are multiplied (left to
        right)."""
        names = str(name).split()
        op = getattr(self, names[0])
        for n in names[1:]:
            op = npc.tensordot(op, getattr(self, n), axes=[[1], [0]])
            op.iset_leg_labels(['p', 'p*'])
        return op

    def get_hc_op_name(self, name):
        hc_names = []
        for n in reversed(str(name).split()):
            if n not in self.hc_ops:
                raise ValueError(f"hermitian conjugate of {n!r} unknown")
            hc_names.append(self.hc_ops[n])
        return ' '.join(hc_names)

    def op_needs_JW(self, name):
        need = False
        for op in str(name).split():
            if op in self.need_JW_string:
                need = not need
        return need

    def multiply_op_names(self, names):
        return ' '.join(names)


class SpinHalfSite(Site):
    """Spin-1/2: states ``['up', 'down']``.

    Operators: Sz, Sp, Sm, Sigmaz, and without Sz conservation also Sx,
    Sy, Sigmax, Sigmay.  ``conserve`` in {'Sz', 'parity', 'None'}.
    """

    def __init__(self, conserve='Sz', sort_charge=True):
        conserve = conserve or 'None'
        if conserve not in ('Sz', 'parity', 'None'):
            raise ValueError(f"invalid conserve {conserve!r}")
        Sx = [[0., 0.5], [0.5, 0.]]
        Sy = [[0., -0.5j], [0.5j, 0.]]
        Sz = [[0.5, 0.], [0., -0.5]]
        ops = dict(Sp=[[0., 1.], [0., 0.]], Sm=[[0., 0.], [1., 0.]], Sz=Sz)
        if conserve == 'Sz':
            leg = LegCharge.from_qflat(ChargeInfo([1], ['2*Sz']), [1, -1])
        else:
            ops.update(Sx=Sx, Sy=Sy)
            if conserve == 'parity':
                leg = LegCharge.from_qflat(ChargeInfo([2], ['parity_Sz']),
                                           [1, 0])
            else:
                leg = LegCharge.from_trivial(2)
        self.conserve = conserve
        Site.__init__(self, leg, ['up', 'down'], sort_charge=sort_charge,
                      **ops)
        self.state_labels['-0.5'] = self.state_labels['down']
        self.state_labels['0.5'] = self.state_labels['up']
        if conserve != 'Sz':
            self.add_op('Sigmax', 2. * np.asarray(Sx), permute_dense=True)
            self.add_op('Sigmay', 2. * np.asarray(Sy), permute_dense=True)
        self.add_op('Sigmaz', 2. * np.asarray(Sz), permute_dense=True)
        self.charge_to_JW_parity = np.zeros(leg.chinfo.qnumber, int)

    def __repr__(self):
        return f"SpinHalfSite({self.conserve!r})"


class SpinSite(Site):
    """Spin-S: ``2S+1`` states from ``'down'`` (Sz = -S) to ``'up'``
    (Sz = +S), also labelled by their Sz (``'-1.0'``, ..., ``'1.0'``).

    Operators: Sz, Sp, Sm, and without Sz conservation also Sx, Sy.
    ``conserve`` in {'Sz', 'parity', 'None'} (``tenpy_tpu``'s 'dipole' is
    not ported).
    """

    def __init__(self, S=0.5, conserve='Sz', sort_charge=True):
        conserve = conserve or 'None'
        if conserve not in ('Sz', 'parity', 'None'):
            raise ValueError(f"invalid conserve {conserve!r}")
        self.S = S = float(S)
        d = 2 * S + 1
        if d <= 1 or np.rint(d) != d:
            raise ValueError("S must be half-integer")
        d = int(d)
        Sz_diag = -S + np.arange(d)
        Sp = np.zeros((d, d))
        for n in range(d - 1):
            m = n - S
            Sp[n + 1, n] = np.sqrt(S * (S + 1) - m * (m + 1))
        Sm = Sp.T.copy()
        ops = dict(Sp=Sp, Sm=Sm, Sz=np.diag(Sz_diag))
        if conserve == 'Sz':
            leg = LegCharge.from_qflat(ChargeInfo([1], ['2*Sz']),
                                       np.array(2 * Sz_diag, np.int64))
        else:
            ops.update(Sx=0.5 * (Sp + Sm), Sy=0.5j * (Sm - Sp))
            if conserve == 'parity':
                leg = LegCharge.from_qflat(ChargeInfo([2], ['parity_Sz']),
                                           np.mod(np.arange(d), 2))
            else:
                leg = LegCharge.from_trivial(d)
        self.conserve = conserve
        names = [str(i) for i in np.arange(-S, S + 1, 1.)]
        Site.__init__(self, leg, names, sort_charge=sort_charge, **ops)
        self.state_labels['down'] = self.state_labels[names[0]]
        self.state_labels['up'] = self.state_labels[names[-1]]
        self.charge_to_JW_parity = np.zeros(leg.chinfo.qnumber, int)

    def __repr__(self):
        return f"SpinSite(S={self.S}, {self.conserve!r})"


class FermionSite(Site):
    """Spinless fermions: states ``['empty', 'full']``.

    Operators: JW, C (annihilate), Cd (create), N, dN, dNdN; ``C`` and
    ``Cd`` need a Jordan-Wigner string.  ``conserve`` in {'N', 'parity',
    None}.
    """

    def __init__(self, conserve='N', filling=0.5):
        conserve = conserve or 'None'
        if conserve not in ('N', 'parity', 'None'):
            raise ValueError(f"invalid conserve {conserve!r}")
        dN = np.array([[-filling, 0.], [0., 1. - filling]])
        ops = dict(JW=np.array([[1., 0.], [0., -1.]]),
                   C=np.array([[0., 1.], [0., 0.]]),
                   Cd=np.array([[0., 0.], [1., 0.]]),
                   N=np.array([[0., 0.], [0., 1.]]), dN=dN, dNdN=dN ** 2)
        if conserve == 'None':
            leg = LegCharge.from_trivial(2)
        else:
            chinfo = (ChargeInfo([1], ['N']) if conserve == 'N'
                      else ChargeInfo([2], ['parity_N']))
            leg = LegCharge.from_qflat(chinfo, [0, 1])
        self.conserve = conserve
        self.filling = filling
        Site.__init__(self, leg, ['empty', 'full'], sort_charge=True, **ops)
        self.need_JW_string |= {'C', 'Cd', 'JW'}
        if conserve != 'None':
            self.charge_to_JW_parity = np.array([1])

    def __repr__(self):
        return f"FermionSite({self.conserve!r}, filling={self.filling})"


class SpinHalfFermionSite(Site):
    """Spin-1/2 fermions: states ``['empty', 'up', 'down', 'full']``.

    Operators: JW/JWu/JWd, Cu/Cdu (annihilate/create up), Cd/Cdd (down),
    Nu/Nd/Ntot/NuNd/dN, Sz/Sp/Sm (and Sx/Sy without Sz conservation).
    Convention: ``full = Cdu Cdd |empty>``.  ``cons_N`` in {'N', 'parity',
    None}, ``cons_Sz`` in {'Sz', 'parity', None}.
    """

    def __init__(self, cons_N='N', cons_Sz='Sz', filling=1.):
        cons_N = cons_N or None
        cons_Sz = cons_Sz or None
        if cons_N not in ('N', 'parity', None):
            raise ValueError(f"invalid cons_N {cons_N!r}")
        if cons_Sz not in ('Sz', 'parity', None):
            raise ValueError(f"invalid cons_Sz {cons_Sz!r}")
        d = 4
        states = ['empty', 'up', 'down', 'full']
        Nu_diag = np.array([0., 1., 0., 1.])
        Nd_diag = np.array([0., 0., 1., 1.])
        JWu = np.diag(1. - 2. * Nu_diag)
        JWd = np.diag(1. - 2. * Nd_diag)
        Cu = np.zeros((d, d))
        Cu[0, 1] = Cu[2, 3] = 1.
        # annihilate down: the sign of moving past c_u in |full>
        Cd_ = np.zeros((d, d))
        Cd_[0, 2] = 1.
        Cd_[1, 3] = -1.
        Sp = Cu.T @ Cd_   # S^+ = c^dag_up c_down
        ops = dict(JW=JWu @ JWd, JWu=JWu, JWd=JWd, Cu=Cu, Cdu=Cu.T.copy(),
                   Cd=Cd_, Cdd=Cd_.T.copy(), Nu=np.diag(Nu_diag),
                   Nd=np.diag(Nd_diag), Ntot=np.diag(Nu_diag + Nd_diag),
                   NuNd=np.diag(Nu_diag * Nd_diag),
                   dN=np.diag(Nu_diag + Nd_diag - filling),
                   Sz=np.diag(0.5 * (Nu_diag - Nd_diag)), Sp=Sp,
                   Sm=Sp.T.copy())
        qmod, qnames, charges = [], [], []
        if cons_N == 'N':
            qnames.append('N')
            qmod.append(1)
            charges.append([0, 1, 1, 2])
        elif cons_N == 'parity':
            qnames.append('parity_N')
            qmod.append(2)
            charges.append([0, 1, 1, 0])
        if cons_Sz == 'Sz':
            qnames.append('2*Sz')
            qmod.append(1)
            charges.append([0, 1, -1, 0])
        elif cons_Sz == 'parity':
            qnames.append('parity_Sz')
            qmod.append(4)
            charges.append([0, 1, 3, 0])
        if cons_Sz is None:
            ops.update(Sx=0.5 * (Sp + Sp.T), Sy=0.5j * (Sp.T - Sp))
        if len(qmod) == 0:
            leg = LegCharge.from_trivial(d)
        else:
            leg = LegCharge.from_qflat(ChargeInfo(qmod, qnames),
                                       np.array(charges).T)
        self.cons_N = cons_N
        self.cons_Sz = cons_Sz
        self.filling = filling
        Site.__init__(self, leg, states, sort_charge=True, **ops)
        self.need_JW_string |= {'Cu', 'Cdu', 'Cd', 'Cdd', 'JWu', 'JWd', 'JW'}
        if cons_N in ('N', 'parity'):
            self.charge_to_JW_parity = np.array([1] + [0] * (len(qmod) - 1))

    def __repr__(self):
        return (f"SpinHalfFermionSite({self.cons_N!r}, {self.cons_Sz!r}, "
                f"{self.filling})")
