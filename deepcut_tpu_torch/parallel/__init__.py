"""Train and eval steps (the counterparts of `deepcut_tpu.parallel`); one
device only until the multi-GPU slice of the port."""
