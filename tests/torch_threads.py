"""The thread policy of the port's test files, in one place.

The tier-1 run puts several test workers on one machine; a torch that
takes every core's threads in each of them spends the run fighting over
cores.  Every tests/test_torch_*.py file imports `_torch_threads`:

    from tests.torch_threads import _torch_threads  # noqa: F401

(the card's test files, and test_torch_proposals.py which they import,
take it as `torch_threads`, as they take `synth`: where an installed
package is named `tests`, "tests." imports resolve to it).

For the module's duration torch takes THREADS intra-op threads, and
OMP_NUM_THREADS and MKL_NUM_THREADS say the same to every child process
it starts (a child that builds its environment from nothing takes
`CHILD_ENV`).  All three are restored afterwards: a worker runs several
files in one process, hgtpu's among them.
"""
import os

import pytest
import torch

THREADS = 2
CHILD_ENV = {"OMP_NUM_THREADS": str(THREADS),
             "MKL_NUM_THREADS": str(THREADS)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    env = {k: os.environ.get(k) for k in CHILD_ENV}
    torch.set_num_threads(THREADS)
    os.environ.update(CHILD_ENV)
    yield
    torch.set_num_threads(n)
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
