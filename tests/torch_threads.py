"""
A fixture that caps a test module's CPU threads: torch's intra-op pool and
the BLAS pools threadpoolctl can reach (scipy's sqrtm), restored after the
module. The tier-1 run puts six pytest workers on the host's cores, and each
worker's torch would otherwise start one spinning thread per core.
"""

import pytest

MODULE_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    torch = pytest.importorskip("torch")
    saved = torch.get_num_threads()
    torch.set_num_threads(MODULE_THREADS)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = None
    else:
        limits = threadpool_limits(limits=MODULE_THREADS)
    try:
        yield
    finally:
        if limits is not None:
            limits.restore_original_limits()
        torch.set_num_threads(saved)
