"""One torch intra-op thread in each CPU test process.

The test run puts several pytest-xdist workers on one host's cores.  Each
worker would otherwise run torch's default pool of one thread per core, and
the pools oversubscribe the cores: a tiny CoAM train step that takes 0.13 s
alone took 44.5 s with six such workers at once (0.17 s with one thread
each).  Every ``tests/test_torch_port_*.py`` imports this module first; a
worker imports every test file it collects, so the cap holds for the whole
worker.  It imports no JAX (the card tests run without conftest.py) and
leaves a process that sees a card as it is.
"""

import torch

if not torch.cuda.is_available():
    torch.set_num_threads(1)
