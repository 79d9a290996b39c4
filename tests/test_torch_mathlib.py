"""The port's elementwise math is correctly rounded from a process's
first call.

On the CPU, PyTorch takes sqrt, exp and log2 of a large tensor from
MKL's vector math, split across its threads; the library's first call
in a process, spread over every thread at once, could return one
thread's share at ~12-bit accuracy (mathlib/precise.py).  Each
subprocess here is fresh, imports the port (whose package import makes
that first call itself), and takes the functions of 6.2M floats, a 1080p
frame's worth of three-vectors; several run at once, as the test
workers do.  Each result must be within 2 ulp of numpy's float64 value
rounded to float32.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import numpy as np, torch
import toyrenderer_tpu_torch
x = np.random.default_rng({seed}).uniform(1e-6, 4.0, 6220800).astype(np.float32)
t = torch.from_numpy(x)
worst = []
for got, ref in ((torch.sqrt(t), np.sqrt), (torch.exp(t), np.exp),
                 (torch.log2(t), np.log2)):
    want = ref(x.astype(np.float64)).astype(np.float32)
    ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    worst.append(int(ulp.max()))
print(*worst)
"""


def test_first_calls_are_correctly_rounded():
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD.format(seed=seed)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for seed in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        sqrt_ulp, exp_ulp, log2_ulp = map(int, out.split())
        assert max(sqrt_ulp, exp_ulp, log2_ulp) <= 2, out
