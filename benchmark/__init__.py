"""The benchmark of the PyTorch and CUDA port (``sgs_gnn_tpu_torch``):
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. It imports the port, plain PyTorch and NumPy, and nothing
of the JAX package."""
