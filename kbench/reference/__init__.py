"""Plain PyTorch references of the served models, in float32, one file a
block kind. They import nothing of the port."""
