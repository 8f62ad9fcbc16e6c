"""One intra-op thread for torch's CPU ops in the port's tests.

The tier-1 command runs the test files in six pytest-xdist worker
processes at once. With torch's default (one intra-op thread per core in
each worker) the workers' threads contend for the cores, and the plain
versions, which run long chains of small ops (a few per object and loop),
wait on that contention: kernel 1's plain record of sphere_field(1024) at
128x96 b5 (``tests/test_torch_champ_order.py``'s ``field_record``) took
726-876 s of such a run on an 8-core host against 17-20 s alone.

Every ``tests/test_torch_*.py`` imports ``one_thread``, an autouse fixture
of module scope, so that each module's fixtures (module-scoped ones too:
autouse fixtures of a scope run first) and tests run with one intra-op
thread, and the count from before the module is restored after it. Test
bodies that run on a thread of their own take the count set here when
their first parallel op starts."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
