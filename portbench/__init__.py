"""The benchmark of the PyTorch and CUDA port (``pogema_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything one configuration, one
traffic mix or one metric needs is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names ``drivers/<driver>.py``), ``metrics/<metric>.py`` and
``limits/<cell>.json``.
"""
