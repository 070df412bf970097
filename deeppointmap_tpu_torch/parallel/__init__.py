"""Training steps, data parallelism and batch extraction (port of
deeppointmap_tpu/parallel/train_step.py, mesh.py and sharded_extract.py):
the registration and loop steps on one device, DDP over
torch.distributed, one process per device, in place of the JAX package's
device mesh, and offline descriptor extraction over a list of devices."""
