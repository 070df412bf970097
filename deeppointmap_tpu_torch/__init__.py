"""PyTorch/CUDA port of deeppointmap_tpu for NVIDIA Hopper (H100).

The inference engine (slam/engine.py) with device preprocessing, the
encoder, registration and the information matrix. Two kernels are written
by hand in CUDA C++ for sm_90a (csrc/), built at first use by kernels.py:
K1 farthest-point sampling and K2 exact kNN with radius moments. Every
entry point runs on `cuda` unless the caller passes device="cpu", where
each kernel's plain PyTorch version runs instead. No module here imports
JAX or the JAX package.
"""
