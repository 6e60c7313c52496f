"""The Caffe graph engine: a prototxt interpreted into a plan of layer
functions over NCHW tensors (`core.graph.Net`, `core.layers`, `core.fillers`)."""
