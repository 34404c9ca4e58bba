"""The benchmark of the PyTorch/CUDA port (``transformer_recommenders_tpu_torch``).

One run: ``python -m recbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  Cells are the ``workloads`` of
the root ``BENCHMARK.json``; each names a configuration
(``recbench/configs/<name>.json``) and a traffic mix
(``recbench/traffic/<name>.json``, whose ``kind`` picks a driver in
``recbench/drivers/``).  Per-layer metrics are readers in
``recbench/metrics/<metric name>.py``; the limits of each cell's correctness
check are ``recbench/limits/<cell>.json``.  Nothing here imports JAX or the
JAX package.
"""
