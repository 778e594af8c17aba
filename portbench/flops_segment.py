"""The segment cells' yardstick, frozen: the network's operations per crop,
the slide's crops per image, and the tail's minimal work.

The network is read from the configuration (``backbone`` depths and
widths, ``decode_head`` channels, pool scales and classes): UPerNet on
ConvNeXt as mmseg builds it, every convolution and linear layer at 2
operations a multiply-add (normalisations, activations, pooling and the
head's upsampling not counted). At a 512² crop, ConvNeXt-B with the
512-channel UPerHead is 292 GMAC (backbone 80, head 212). The
auxiliary FCNHead does not run at inference and is not counted.

The tail (``fuse_roofline.segment``): the crops' quarter-resolution float32
logits read once and the uint8 labels written once; 8 operations an
output of each bilinear stage (four taps, a multiply and an add each), an
add per crop value averaged and a divide per averaged value, one compare
per class and pixel for the argmax, whatever computes it. Those are
float32 operations outside the tensor cores: 67 TFLOP/s on one H100 SXM
(data sheet, 700 W); HBM 3.35 TB/s; float16 on the tensor cores 989.
"""

from __future__ import annotations

from portbench.reference.upernet import rescale_size

PEAK_FP16 = 989e12
PEAK_FP32 = 67e12  # CUDA cores, not the tensor cores
PEAK_BYTES_PER_S = 3.35e12


def _side(n: int, stride: int) -> int:
    return n // stride


def network_flops(config: dict, h: int, w: int) -> float:
    """Operations of one forward of an [h, w] crop."""
    bb, head = config["backbone"], config["decode_head"]
    depths, widths = bb["depths"], bb["widths"]
    ratio = bb.get("mlp_ratio", 4)
    k = bb.get("kernel", 7)
    macs = 0.0
    sizes = []
    hh, ww = _side(h, 4), _side(w, 4)
    macs += hh * ww * widths[0] * 3 * 16  # 4×4 patchify stem
    for i, (d, c) in enumerate(zip(depths, widths)):
        if i:
            hh, ww = _side(hh, 2), _side(ww, 2)
            macs += hh * ww * c * widths[i - 1] * 4  # 2×2 stride-2 downsample
        macs += d * hh * ww * c * (k * k + 2 * ratio * c)  # depthwise, two pointwise
        sizes.append((hh, ww))
    ch, n_cls = head["channels"], head["num_classes"]
    scales = head["pool_scales"]
    top = widths[-1]
    macs += sum(s * s for s in scales) * top * ch  # PPM 1×1 convs on the pooled maps
    h3, w3 = sizes[-1]
    macs += h3 * w3 * (top + len(scales) * ch) * ch * 9  # PSP bottleneck 3×3
    for (hi, wi), c in zip(sizes[:-1], widths[:-1]):
        macs += hi * wi * c * ch  # lateral 1×1
        macs += hi * wi * ch * ch * 9  # FPN 3×3
    h0, w0 = sizes[0]
    macs += h0 * w0 * len(widths) * ch * ch * 9  # FPN bottleneck 3×3 on the concatenation
    macs += h0 * w0 * ch * n_cls  # conv_seg
    return 2.0 * macs


def slide_crops(n: int, crop: int, stride: int) -> int:
    """mmseg's slide grid along one side of n pixels."""
    return max(n - crop + stride - 1, 0) // stride + 1


def crops_per_image(config: dict, h: int, w: int) -> int:
    rh, rw = rescale_size(h, w, config["test_pipeline"]["img_scale"])
    (ch, cw), (sh, sw) = config["test_cfg"]["crop_size"], config["test_cfg"]["stride"]
    return slide_crops(rh, ch, sh) * slide_crops(rw, cw, sw)


def image_flops(config: dict, h: int, w: int) -> float:
    """The network's operations on one [h, w] image: its slide's crops."""
    ch, cw = config["test_cfg"]["crop_size"]
    return crops_per_image(config, h, w) * network_flops(config, ch, cw)


def tail_cost(images: int, crops: int, crop_h: int, crop_w: int, qh: int, qw: int,
              region_h: int, region_w: int, out_h: int, out_w: int, classes: int) -> tuple:
    """(flops, bytes) of the tail for `images` images of `crops` crops each."""
    per_crop = crop_h * crop_w * classes
    flops = (crops * per_crop * (8 + 1) + region_h * region_w * classes
             + out_h * out_w * classes * (8 + 1))
    nbytes = crops * qh * qw * classes * 4 + out_h * out_w
    return float(images * flops), float(images * nbytes)


def roofline_share(flops: float, nbytes: float, seconds: float) -> float | None:
    """The least time (operations on the CUDA cores or bytes, the larger)
    over the measured time, in %."""
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    return 100.0 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES_PER_S) / seconds
