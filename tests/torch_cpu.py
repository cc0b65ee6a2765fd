"""One intra-op thread for PyTorch in the test processes.

Under ``pytest -n`` six workers share the CPU, and PyTorch's OpenMP pool of
one thread per core in each worker oversubscribes it: the pools' threads
spin against each other, and a port test that takes 0.2 s alone can take
100 s beside the others (the whole suite's CPU time doubles).  Every
``tests/test_torch_*.py`` imports this module; the setting is per process
and every xdist worker imports every test module when it collects, so it
holds in each worker for the JAX files it runs as well (their XLA thread
pools are separate and unaffected).
"""

import torch

torch.set_num_threads(1)
