"""One intra-op thread for torch in the port's CPU tests.

Importing this module sets it for the process; every tests/test_torch_*.py
imports it. The tests run thousands of small tensor ops (a few thousand
lanes, tables of a few hundred rows), where torch's intra-op pool costs
more than it gives, and under pytest-xdist each worker's pool (a thread a
core) competes for the same cores with the others': on an 8-core machine
test_torch_cull_bounds.py took 455 s of test time in a six-worker run of
the tier, and 17 s with one thread a worker. Results do not depend on it:
the plain versions fix their orders of summation.
"""

import torch

torch.set_num_threads(1)
