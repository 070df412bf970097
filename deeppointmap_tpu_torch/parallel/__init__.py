"""Training steps and data parallelism (port of deeppointmap_tpu/parallel/
train_step.py and mesh.py): the registration and loop steps on one device,
and DDP over torch.distributed, one process per device, in place of the
JAX package's device mesh."""
