"""One intra-op torch thread for a test module.

Under the suite's parallel workers (``-n 6`` on eight cores), each
worker's torch pool of one thread per core oversubscribes the machine,
and the small smoke-size ops of the port's tests spend their time in the
pool's synchronisation: a port-only engine test that takes under a second
alone took a minute there, and the port's test files took 1155 s under
``-n 6`` with the default pools against 240 s with ``OMP_NUM_THREADS=1``.
A module that imports ``one_torch_thread`` runs on one thread and
restores the count after it.  Every port test passes both ways."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
