"""One intra-op torch thread for a test module of the port.

The suite runs its test files in parallel worker processes (pytest-xdist,
`--dist loadfile`). A worker whose torch ops each fan out over every core,
beside the other workers doing the same, spends most of its time waiting
on its own thread pool: small ops (MD steps, the small model, the training
loops) ran many times slower in the full suite than alone. A test module
of the port imports `one_torch_thread`; the previous count comes back when
the module ends, so the next module in the worker runs as it would alone.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
