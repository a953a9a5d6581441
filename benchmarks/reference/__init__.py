"""Plain reference implementations the benchmark judges the program by.

PyTorch and NumPy only: nothing here imports ``jax``, the JAX package or
the program (``softspoken_tpu_torch``), and nothing takes what the program
made; the inputs are the files the benchmark wrote and the weights file.
"""
