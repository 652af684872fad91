r"""A charge-blocked array on the host: the input and output of packing.

The slice of ``tenpy_tpu.linalg.np_conserved.Array`` that
:func:`~tenpy_tpu_torch.linalg.packed.pack`,
:func:`~tenpy_tpu_torch.linalg.packed.unpack` and
:func:`~tenpy_tpu_torch.linalg.padding.embed_array` touch: legs, total
charge, labels, and one numpy block per stored charge sector.  All arithmetic
happens on the packed layout, never here.
"""

from __future__ import annotations

import numpy as np

from .charges import QTYPE

__all__ = ['HostArray', 'conj_label']


def conj_label(lab):
    """``'a'`` <-> ``'a*'`` (the label of the conjugate leg)."""
    if lab is None:
        return None
    return lab[:-1] if lab.endswith('*') else lab + '*'


def _lexsort_rows(qdata):
    if qdata.shape[0] < 2:
        return np.arange(qdata.shape[0])
    return np.lexsort(qdata.T[::-1])


class HostArray:
    """Block-sparse array with numpy blocks.

    Attributes
    ----------
    legs : tuple of LegCharge
    dtype : np.dtype
    qtotal : tuple of int
    _qdata : np.ndarray (n_blocks, rank), rows lexsorted
    _data : list of np.ndarray, one block per row of ``_qdata``
    """

    def __init__(self, legs, dtype=np.float64, qtotal=None, labels=None):
        legs = tuple(legs)
        if not legs:
            raise ValueError("HostArray needs at least one leg")
        chinfo = legs[0].chinfo
        if any(l.chinfo != chinfo for l in legs[1:]):
            raise ValueError("legs with different ChargeInfo")
        self.legs = legs
        self.dtype = np.dtype(dtype)
        self.qtotal = tuple(int(q) for q in chinfo.make_valid(qtotal))
        self._labels = tuple(labels) if labels is not None \
            else (None,) * len(legs)
        self._qdata = np.zeros((0, len(legs)), QTYPE)
        self._data = []

    @property
    def chinfo(self):
        return self.legs[0].chinfo

    @property
    def rank(self):
        return len(self.legs)

    def get_leg_index(self, label):
        if isinstance(label, (int, np.integer)):
            k = int(label)
            return k + self.rank if k < 0 else k
        try:
            return self._labels.index(label)
        except ValueError:
            raise KeyError(f"label {label!r} not in {self._labels}") from None

    def get_leg(self, label):
        return self.legs[self.get_leg_index(label)]

    def get_leg_labels(self):
        return self._labels

    def _set_blocks(self, qdata, data):
        """Set blocks, establishing canonical (row-lexsorted) order."""
        qdata = np.asarray(qdata, QTYPE).reshape(-1, self.rank)
        perm = _lexsort_rows(qdata)
        self._qdata = qdata[perm]
        self._qdata.setflags(write=False)
        self._data = [data[p] for p in perm]
        return self

    def transpose(self, perm):
        """New array with legs permuted; ``perm`` holds indices or labels."""
        perm = tuple(self.get_leg_index(p) for p in perm)
        if sorted(perm) != list(range(self.rank)):
            raise ValueError("invalid permutation")
        res = HostArray([self.legs[p] for p in perm], self.dtype, self.qtotal,
                        [self._labels[p] for p in perm])
        res._set_blocks(self._qdata[:, perm],
                        [np.transpose(b, perm) for b in self._data])
        return res

    def iproject(self, mask, axis):
        """Project leg ``axis`` onto the boolean ``mask`` in place."""
        ax = self.get_leg_index(axis)
        map_qind, block_masks, new_leg = self.legs[ax].project(mask)
        qdata, data = [], []
        for row, block in zip(self._qdata, self._data):
            nq = map_qind[row[ax]]
            if nq < 0:
                continue
            new_row = np.array(row, QTYPE)
            new_row[ax] = nq
            qdata.append(new_row)
            data.append(np.take(block, np.nonzero(block_masks[row[ax]])[0],
                                axis=ax))
        legs = list(self.legs)
        legs[ax] = new_leg
        self.legs = tuple(legs)
        self._set_blocks(np.array(qdata, QTYPE).reshape(len(qdata), self.rank),
                         data)
        return self
