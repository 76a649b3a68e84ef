"""The paper's evaluation target: the convolutional layers of VGG-B
(Simonyan & Zisserman, Table 1 column B); the port's copy of
``repro/configs/vggb.py``.

Each entry: (name, in_channels, out_channels, H, W). Kernels are 3x3,
stride 1, padding 1, so each layer's output is H x W.
"""

VGGB_LAYERS = [
    ("conv1_1", 3, 64, 224, 224),
    ("conv1_2", 64, 64, 224, 224),
    ("conv2_1", 64, 128, 112, 112),
    ("conv2_2", 128, 128, 112, 112),
    ("conv3_1", 128, 256, 56, 56),
    ("conv3_2", 256, 256, 56, 56),
    ("conv4_1", 256, 512, 28, 28),
    ("conv4_2", 512, 512, 28, 28),
    ("conv5_1", 512, 512, 14, 14),
    ("conv5_2", 512, 512, 14, 14),
]
