"""The benchmark of the PyTorch port (``vla_fastvlm_tpu_torch``) on one H100:
``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
