"""PyTorch/CUDA port of the device-resident iDMRG sweep of ``tenpy_tpu``.

The package mirrors ``tenpy_tpu``'s module layout (``linalg``,
``algorithms``, ``networks``) but imports ``torch`` and never ``jax``.  Every
packed tensordot is one launch of a hand-written CUDA kernel of
``csrc/packed_contract.cu`` when its tensors live on a CUDA device; on the
CPU the same wrapper takes its plain PyTorch version.  The entry points
(``pack``, ``DeviceSweepEngine``) put their tensors on the card unless the
caller passes ``device='cpu'``.

The host-side setup that needs the MPS/MPO machinery (charge gauge, MPO
rescale, transfer-matrix environments) is not ported yet: it arrives through
the exchange file of :mod:`tenpy_tpu_torch.networks.exchange`.
"""

__version__ = '0.1.0'
