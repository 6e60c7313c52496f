"""Caffe-exact update rules and the DeeperCut training loop, in PyTorch
(the counterparts of `deepcut_tpu.solver`)."""
