"""PyTorch/CUDA port of deeppointmap_tpu for NVIDIA Hopper (H100).

Single-agent SLAM from the CLI (pipeline/infer.py) through SlamSystem
(slam/system.py) and its modules down to the inference engine
(slam/engine.py): device preprocessing, the encoder, registration, loop
scoring and the information matrix. Four kernels are written by hand in
CUDA C++ for sm_90a (csrc/), built at first use by kernels.py: K1
farthest-point sampling, K2 exact kNN with radius moments, K3 radius moments
over all points and K4 the fused preprocessing sweep. Every entry point runs
on `cuda` unless the caller passes device="cpu", where each kernel's plain
PyTorch version runs instead. No module here imports JAX or the JAX package.
"""
