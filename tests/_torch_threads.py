"""Two threads for torch's intra-op pool and for OpenBLAS while a test
file runs: ``from _torch_threads import two_torch_threads  # noqa: F401``
makes the autouse fixture below one of the file's.

The suite runs in several worker processes at once (the tier-1 command:
6 on 8 cores). With torch's and OpenBLAS's default of one thread per core
in each, the workers oversubscribe the machine, and small CPU ops then
wait on each other's spinning threads: a CPU demo run took over 100 s
instead of 1 s, the train entry point's test ~690 s instead of ~25 s, and
FID's two 2048-square ``sqrtm`` ~170 s instead of ~20 s.
"""
import pytest
import torch
from threadpoolctl import threadpool_limits

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        with threadpool_limits(THREADS):
            yield
    finally:
        torch.set_num_threads(n)
