"""Host input pipeline: window files, the pose data source, workers."""
