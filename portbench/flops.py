"""The yardstick's arithmetic, frozen: peaks, operation and byte counts.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, without
sparsity) at its full 700 W: 989 TFLOP/s bf16, 495 TFLOP/s TF32 (the
tensor cores' rate for float32 operands), 3.35 TB/s of HBM.

``SFD2_LAYERS`` is ResSegNetV2 as published (``nets/sfd2.py`` of
github.com/feixue94/sfd2, descriptor width 128): every convolution with
its input and output channels, kernel, stride, groups and the resolution
it runs at, as a fraction of the input's. Counts come from this table,
not from the program's modules, so fusing a layer or changing a dtype in
the program does not move them.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12

# (name, cin, cout, kernel, stride, groups, bias, input resolution divisor)
SFD2_LAYERS = (
    ("conv1a.0", 3, 64, 3, 1, 1, True, 1),
    ("conv1b.0", 64, 64, 3, 2, 1, True, 1),
    ("conv2a.0", 64, 128, 3, 1, 1, True, 2),
    ("conv2b.0", 128, 128, 3, 2, 1, True, 2),
    ("conv3a.0", 128, 256, 3, 1, 1, True, 4),
    ("conv3b.0", 256, 256, 3, 1, 1, True, 4),
    *((f"conv4.{i}.{c}", 256, 256, k, 1, g, False, 4)
      for i in range(3) for c, k, g in (("conv1", 1, 1), ("conv2", 3, 32), ("conv3", 1, 1))),
    ("convPa.0", 256, 256, 3, 2, 1, True, 4),
    ("convPa.3", 256, 256, 3, 1, 1, True, 8),
    ("convPb", 256, 65, 1, 1, 1, True, 8),
    ("convDa.0", 256, 256, 3, 1, 1, True, 4),
    ("convDa.3", 256, 256, 3, 1, 1, True, 4),
    ("convDb", 256, 128, 1, 1, 1, True, 4),
    ("ConvSta", 256, 3, 1, 1, 1, True, 4),
)
# BatchNorms: (name, channels, affine)
SFD2_NORMS = (
    ("conv1a.1", 64, False), ("bn1b.0", 64, False), ("conv2a.1", 128, False),
    ("bn2b.0", 128, False), ("conv3a.1", 256, False), ("bn3b.0", 256, False),
    *((f"conv4.{i}.bn{j}", 256, True) for i in range(3) for j in (1, 2, 3)),
    ("convPa.1", 256, True), ("convDa.1", 256, True),
)
STEM = SFD2_LAYERS[:2]  # K1 fuses conv1a (with its norm and ReLU) and conv1b


def _side(n: int, div: int) -> int:
    """A side at 1/div of n, as padding-1 stride-2 convolutions round it."""
    while div > 1:
        n, div = -(-n // 2), div // 2
    return n


def conv_shapes(b: int, h: int, w: int, layers=SFD2_LAYERS):
    """(name, weight numel, input numel, output numel, flops) per convolution
    at input [b, h, w, 3]."""
    out = []
    for name, cin, cout, k, stride, groups, _, div in layers:
        hi, wi = _side(h, div), _side(w, div)
        ho, wo = -(-hi // stride), -(-wi // stride)
        wn = cout * (cin // groups) * k * k
        out.append((name, wn, b * cin * hi * wi, b * cout * ho * wo,
                    2.0 * wn * b * ho * wo))
    return out


def network_flops(b: int, h: int, w: int) -> float:
    return sum(s[4] for s in conv_shapes(b, h, w))


def network_bytes(b: int, h: int, w: int, trunk_bytes: int = 2) -> float:
    """The image in float32, the stem's float32 weights, out1c in the trunk's
    dtype, then each later layer's input, weights and output once in it."""
    shapes = conv_shapes(b, h, w)
    total = b * h * w * 3 * 4 + (shapes[0][1] + shapes[1][1]) * 4 + shapes[1][3] * trunk_bytes
    for _, wn, inp, outp, _ in shapes[2:]:
        total += (inp + wn + outp) * trunk_bytes
    return float(total)


def stem_cost(b: int, h: int, w: int, out_bytes: int = 2) -> tuple:
    """(flops, bytes) of K1: conv1a and conv1b; the float32 image in, the
    float32 weights, out1c out in the trunk's dtype."""
    shapes = conv_shapes(b, h, w, STEM)
    flops = shapes[0][4] + shapes[1][4]
    nbytes = b * h * w * 3 * 4 + (shapes[0][1] + shapes[1][1]) * 4 + shapes[1][3] * out_bytes
    return flops, float(nbytes)


def match_cost(b: int, n1: int, n2: int, c: int, broadcast: bool, elem: int = 4) -> tuple:
    """(flops, bytes) of one mutual-NN launch: 2·N1·N2·C per pair; the
    query once (once for all pairs when broadcast), the banks, both valid
    masks, and the int32 matches and float32 scores out."""
    flops = 2.0 * b * n1 * n2 * c
    q = (1 if broadcast else b) * n1
    nbytes = (q * c + b * n2 * c) * elem + q + b * n2 + b * n1 * 8
    return flops, float(nbytes)


def roofline_share(flops: float, nbytes: float, seconds: float, peak: str) -> float | None:
    """The least time the card could take (the larger of flops over the
    peak and bytes over the bandwidth) over the measured time, in %."""
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    bound = max(flops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES_PER_S)
    return 100.0 * bound / seconds
