"""The benchmark of kde_tpu_torch, the PyTorch and CUDA port: one command,
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, run from the root of a checkout."""
