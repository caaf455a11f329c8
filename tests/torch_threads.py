"""Thread caps shared by the port's tests (``tests/test_torch_*.py``).

The suite runs under pytest-xdist, several workers on one machine, and
by default each worker's torch would start one compute thread per core,
as would torch and numpy's BLAS in each subprocess that a port file
starts. The threads then outnumber the cores several times over and
spend the machine spinning. Importing this module caps the worker's
torch at one compute thread (every port test file imports it first), and
:func:`subprocess_env` gives a child process the same cap (OpenMP, MKL,
OpenBLAS).
"""
import os

import torch

torch.set_num_threads(1)

_ONE_THREAD = {
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
}
_TESTS = os.path.dirname(os.path.abspath(__file__))


def subprocess_env(**extra) -> dict:
    """This process's environment with every thread pool of a child
    process capped at one thread, updated with ``extra``; ``PYTHONPATH``
    ends with this directory, so that a child that loads a test file
    finds this module."""
    env = dict(os.environ, **_ONE_THREAD, **extra)
    path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(path + [_TESTS])
    return env
