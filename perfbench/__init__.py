"""The benchmark of kytpu_torch, the PyTorch and CUDA port, on one H100.

    python3 perfbench/run.py --workload veach_mis.train64 --seed 7 \
        --seconds 20 --trace 0

`BENCHMARK.json` at the root of the checkout names the cells; each cell's
configuration (configs/), traffic mix (traffic/), correctness limits
(limits/) and metric readers (metrics/) are files found by name, so a new
cell, mix or metric is new files. The yardstick lives here: the plain
reference (reference/), the work counts (counts/), the peaks (peaks.json)
and the profile reduction (profile.py). Nothing here imports JAX or the JAX
package, and the reference imports nothing of the port.
"""
