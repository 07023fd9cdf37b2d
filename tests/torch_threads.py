"""One torch thread for every CPU test module of the port.

Every ``tests/test_torch_*.py`` that runs on the CPU imports
:func:`one_thread` at module level (``from torch_threads import
one_thread``), which pytest then applies to each of its tests
(``tests/test_torch_threads.py`` checks that none forgets it).  The tier-1
run spreads the files over six workers on eight cores: a worker with a
torch thread a core oversubscribes the machine, and a run of many small
ops then spends its time waking threads (``inpaint --model sspain_omp`` on
1 s took 4.0 s alone at 8 threads and 318 s with six copies at once, 6.3 s
at one thread).  ``tests/test_torch_gpu.py`` runs on the card without this
directory's conftest and does not import it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the importing module, restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
