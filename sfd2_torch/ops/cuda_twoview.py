"""Two-view F-RANSAC as hand-written CUDA kernels (Hopper).

No TPU kernel's port: the JAX package leaves its vmapped F-RANSAC to XLA.
The contract is ``sfm/twoview.py::verify_fundamental_ransac_core``, whose
plain version runs as ~2,500 small eager torch ops a batch; at the map
build's batches (32 pairs of 1,024 matches, 2,048 hypotheses) the host's
dispatch of those ops was the cost. ``csrc/twoview.cu`` runs the batch as
three kernels: ``twoview_score`` (one thread per hypothesis: the sample, the
eight-point fit in registers, MSAC over the pair's valid matches in shared
memory, each CTA's best) and ``twoview_refine`` (one CTA per pair: the
winner, 4 steps of local optimisation, the inlier mask), launched by one C
call, after ``twoview_list`` (one CTA per pair: its valid positions in order,
to scratch this wrapper allocates, so any mask and any N work). ``refine``
runs ``twoview_refine`` alone from a given F.

Samples are drawn in the kernel with Philox4x32-10 under a 64-bit key that
the wrapper draws from the caller's ``torch.Generator`` on the device (one
small launch, no wait for the host), or read from ``sample_idx`` [B, H, 8],
which keeps the contract of ``verify_fundamental_ransac_core`` so that the
kernel and the plain version can be fed the same samples.

``ransac`` takes float32 points and bool masks on one CUDA device, at any
number of matches, and raises on anything else; ``sfm/twoview.py`` chooses
the route.
``ransac.launches`` counts calls (three kernels each), ``ransac.shapes`` the
(B, H, N, sampled) of each.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build

SLAB = 10  # floats per CTA of twoview_score: its best MSAC, then F

_lib = None  # the built library, its entries typed, on first use


def _entry():
    global _lib
    if _lib is None:
        lib = cuda_build.load("twoview")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sfd2_twoview_ransac.argtypes = [p, p, p, i, i, i, p, p, f, i, f, p, p, p, p, p, p,
                                            p, p]
        lib.sfd2_twoview_refine.argtypes = [p, p, p, i, i, i, f, i, f, p, p, p, p, p, p]
        for name in ("sfd2_twoview_ransac", "sfd2_twoview_refine", "sfd2_twoview_threads"):
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(fn, dev, *args) -> None:
    """Calls one C entry on `dev`'s current stream; raises on its error."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code:
        cuda_build.check(_entry(), code, f"cuda_twoview.{fn.__name__}")


def _check_points(what, xy1, xy2, valid):
    if not (xy1.is_cuda and xy2.is_cuda and valid.is_cuda):
        raise ValueError(f"cuda_twoview.{what}: needs CUDA tensors, got {xy1.device}, "
                         f"{xy2.device}, {valid.device}")
    if xy1.dim() != 3 or xy1.shape[-1] != 2 or xy2.shape != xy1.shape \
            or tuple(valid.shape) != tuple(xy1.shape[:2]):
        raise ValueError(f"cuda_twoview.{what}: need xy1/xy2 [B, N, 2] and valid [B, N], got "
                         f"{tuple(xy1.shape)}, {tuple(xy2.shape)}, {tuple(valid.shape)}")
    if xy1.dtype != torch.float32 or xy2.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"cuda_twoview.{what}: unsupported dtypes {xy1.dtype}, {xy2.dtype}, "
                         f"{valid.dtype}")
    if xy2.device != xy1.device or valid.device != xy1.device:
        raise ValueError(f"cuda_twoview.{what}: inputs on {xy1.device}, {xy2.device}, "
                         f"{valid.device}")


def draw_key(generator: torch.Generator, device) -> torch.Tensor:
    """Two int64 drawn from `generator` on `device`: the kernel's Philox key."""
    return torch.empty(2, dtype=torch.int64, device=device).random_(generator=generator)


def ransac(xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor, threshold: float,
           min_inliers: int, min_inlier_ratio: float, *, key: torch.Tensor | None = None,
           sample_idx: torch.Tensor | None = None, num_hypotheses: int | None = None,
           msac_out: torch.Tensor | None = None, idx_out: torch.Tensor | None = None):
    """F-RANSAC of B pairs: xy1/xy2 [B, N, 2] float32, valid [B, N] bool on
    one CUDA device; samples drawn in the kernel under `key` (``draw_key``)
    for `num_hypotheses` hypotheses, or given as `sample_idx` [B, H, 8].
    Returns (F [B, 3, 3], inliers [B, N] bool, num_inliers [B] int32,
    success [B] bool); inliers and success are views of one [B, 1 + N]
    buffer. Optional `msac_out` [B, H] float32 and `idx_out` [B, H, 8] int32
    receive every hypothesis' MSAC (inf where its fit failed) and sample."""
    _check_points("ransac", xy1, xy2, valid)
    b, n = valid.shape
    if (key is None) == (sample_idx is None):
        raise ValueError("cuda_twoview.ransac: give exactly one of key and sample_idx")
    if sample_idx is not None:
        if sample_idx.dim() != 3 or sample_idx.shape[0] != b or sample_idx.shape[2] != 8:
            raise ValueError(f"cuda_twoview.ransac: need sample_idx [B, H, 8], got "
                             f"{tuple(sample_idx.shape)}")
        h = sample_idx.shape[1]
        sample_idx = sample_idx.to(torch.int64).contiguous()
    else:
        h = int(num_hypotheses)
        if key.dtype != torch.int64 or key.numel() != 2 or key.device != xy1.device:
            raise ValueError("cuda_twoview.ransac: key must be 2 int64 on the inputs' device")
    if h <= 0:
        raise ValueError(f"cuda_twoview.ransac: {h} hypotheses")
    dev = xy1.device
    for name, t, shape, dt in (("msac_out", msac_out, (b, h), torch.float32),
                               ("idx_out", idx_out, (b, h, 8), torch.int32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"cuda_twoview.ransac: {name} must be a contiguous {dt} "
                             f"{list(shape)} on {dev}")
    xy1, xy2, valid = xy1.contiguous(), xy2.contiguous(), valid.contiguous()
    fmat = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    num = torch.empty(b, dtype=torch.int32, device=dev)
    packed = torch.empty((b, 1 + n), dtype=torch.uint8, device=dev)
    if b:
        lib = _entry()
        threads = lib.sfd2_twoview_threads()
        slabs = torch.empty((b, -(-h // threads), SLAB), dtype=torch.float32, device=dev)
        lst = torch.empty(b * n + b, dtype=torch.int32, device=dev)
        _launch(lib.sfd2_twoview_ransac, dev, xy1.data_ptr(), xy2.data_ptr(), valid.data_ptr(),
                b, n, h, _ptr(key), _ptr(sample_idx), float(threshold) ** 2, int(min_inliers),
                float(min_inlier_ratio), slabs.data_ptr(), lst.data_ptr(), fmat.data_ptr(),
                num.data_ptr(), packed.data_ptr(), _ptr(msac_out), _ptr(idx_out))
        ransac.launches += 1
        ransac.shapes[(b, h, n, sample_idx is None)] += 1
    flags = packed.view(torch.bool)
    return fmat, flags[:, 1:], num, flags[:, 0]


ransac.launches = 0
ransac.shapes = collections.Counter()  # (B, H, N, sampled) of each call


def refine(xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor, fmat: torch.Tensor,
           threshold: float, min_inliers: int, min_inlier_ratio: float):
    """``twoview_refine`` alone: the 4 steps of local optimisation of B pairs
    from F [B, 3, 3] (float32), then the inlier mask and success, as
    ``ransac`` returns them after its winner. Returns (F, inliers,
    num_inliers, success, MSAC [B] after the local optimisation)."""
    _check_points("refine", xy1, xy2, valid)
    b, n = valid.shape
    dev = xy1.device
    if tuple(fmat.shape) != (b, 3, 3) or fmat.dtype != torch.float32 or fmat.device != dev:
        raise ValueError(f"cuda_twoview.refine: need F [B, 3, 3] float32 on {dev}, got "
                         f"{tuple(fmat.shape)} {fmat.dtype} on {fmat.device}")
    slabs = torch.cat([torch.zeros((b, 1), dtype=torch.float32, device=dev),
                       fmat.reshape(b, 9)], 1).contiguous()
    xy1, xy2, valid = xy1.contiguous(), xy2.contiguous(), valid.contiguous()
    f_out = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    num = torch.empty(b, dtype=torch.int32, device=dev)
    packed = torch.empty((b, 1 + n), dtype=torch.uint8, device=dev)
    lo = torch.empty(b, dtype=torch.float32, device=dev)
    if b:
        _launch(_entry().sfd2_twoview_refine, dev, xy1.data_ptr(), xy2.data_ptr(),
                valid.data_ptr(), b, n, 1, float(threshold) ** 2, int(min_inliers),
                float(min_inlier_ratio), slabs.data_ptr(), f_out.data_ptr(), num.data_ptr(),
                packed.data_ptr(), lo.data_ptr())
    flags = packed.view(torch.bool)
    return f_out, flags[:, 1:], num, flags[:, 0], lo


def _ptr(t):
    return None if t is None else t.data_ptr()
