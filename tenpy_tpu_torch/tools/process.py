"""Process-level utilities.

Port of ``memory_usage`` from ``tenpy_tpu/tools/process.py``: the DMRG
engines log it with every sweep.  The thread-control helpers are not
ported (``torch.set_num_threads`` sets the host's threads).
"""

from __future__ import annotations

import os
import resource

__all__ = ['memory_usage']


def memory_usage():
    """Memory usage of this process in MB: the resident set size where
    ``psutil`` is installed, else the peak resident set size."""
    try:
        import psutil
        return psutil.Process(os.getpid()).memory_info().rss / 1024. ** 2
    except ImportError:
        # ru_maxrss is in KB on linux
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.
