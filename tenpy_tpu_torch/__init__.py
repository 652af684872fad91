"""PyTorch/CUDA port of the device-resident iDMRG sweep of ``tenpy_tpu``.

The package mirrors ``tenpy_tpu``'s module layout (``linalg``,
``algorithms``, ``networks``, ``models``, ``tools``) but imports ``torch``
and never ``jax``.  Every packed tensordot is one launch of a hand-written
CUDA kernel of ``csrc/packed_contract.cu`` when its tensors live on a CUDA
device; on the CPU the same wrapper takes its plain PyTorch version.  The
entry points (``pack``, ``DeviceSweepEngine``, ``device_ramp``) put their
tensors on the card unless the caller passes ``device='cpu'``.

A run starts from a model (``models.hubbard``, or the complex
``models.hofstadter``, which runs on complex128 buffers) and an MPS
(``networks.mps``); the engine's host-side setup (charge gauge, MPO
rescale, converged environments) runs on CPU torch blocks
(``linalg.np_conserved``) and is then packed onto the device.
"""

__version__ = '0.1.0'
