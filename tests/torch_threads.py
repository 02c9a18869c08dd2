"""The thread cap of the port's test modules.

The quick tier runs six pytest workers on one box.  A process left alone
starts a thread per core in torch's pool and in each BLAS / OpenMP pool
(numpy's and scipy's OpenBLAS spin while they wait), and six such
processes then contend for the cores: a test module of the port that
takes a minute alone took nine under six workers.  A module that imports
:func:`capped_threads` runs its tests with at most ``THREADS`` threads in
each pool.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    """At most THREADS threads in torch and in every BLAS / OpenMP pool
    while the importing module's tests run, the old counts restored after
    them."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, THREADS))
    if threadpool_limits is None:
        yield
    else:
        with threadpool_limits(limits=THREADS):
            yield
    torch.set_num_threads(old)
