"""The benchmark of ``rustqip_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Each configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``) and metric (``metrics/<name>.py``) is a file of
its own, found by the name ``BENCHMARK.json`` gives; a configuration's
``circuit`` names its program-side builder (``circuits/<circuit>.py``) and
its plain reference (``reference/<circuit>.py``).
"""
