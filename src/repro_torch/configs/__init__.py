"""Architecture configs: dense decoders and the VGG-B conv layers."""
