"""Caffe protobuf codecs: wire format, text format, `.caffemodel`."""
