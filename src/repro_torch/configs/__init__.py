"""Architecture configs: the reference's ten architectures and the VGG-B
conv layers."""
