"""Train and eval steps and data parallelism (the counterparts of
`deepcut_tpu.parallel`): one process per GPU over a `torch.distributed`
group, the 'data' axis; the 'spatial' axis is not ported yet."""
