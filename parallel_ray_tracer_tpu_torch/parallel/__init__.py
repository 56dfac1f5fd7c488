"""Port of parallel_ray_tracer_tpu/parallel/: the training step
(sharded.make_train_step), on one device so far."""
