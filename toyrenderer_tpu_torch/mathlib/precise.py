"""Elementwise math that is correctly rounded from a process's first call.

On the CPU, PyTorch computes sqrt, exp, log2 and their kin through MKL's
vector math library, split across its OpenMP threads.  The library
initialises itself on its first call; when that first call is already
spread over all threads, a thread that enters before the initialisation
is done computes its share at ~12-bit accuracy (sqrt ~4,000 ulp off, exp
~1,800, log2 ~900; seen in 1-7 of 32 fresh processes each, 8 running at
once, on 6.2M floats).  Every later call is within 1 ulp.  So this
module makes that first call itself, at import, on a tensor large enough
to reach every thread, and the package's __init__ imports it: whatever
module of the port a process imports first, its plain torch.sqrt / exp /
log2 calls come after the warm-up.  With it, 96 of 96 fresh processes
were within 1 ulp of numpy (tests/test_torch_mathlib.py repeats the
check).
"""

from __future__ import annotations

import torch

# ATen splits an elementwise op into chunks of at least this many elements
_GRAIN = 32768


def _warm_cpu_vector_math() -> None:
    n = max(1 << 20, 2 * _GRAIN * max(torch.get_num_threads(), 1))
    torch.sqrt(torch.full((n,), 2.0))


_warm_cpu_vector_math()
