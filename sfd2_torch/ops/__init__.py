"""The port's ops, exported as ``sfd2_tpu/ops/__init__.py`` exports them.

The JAX package's Pallas kernels appear under the port's names: the CUDA
wrappers ``mutual_nn_match_cuda`` (K2), ``mutual_nn_ratio_match_cuda`` (K4),
``nn_argmax_cuda`` (K5) and ``nn_top2_cuda`` (K6), each beside its plain
version.

``matching`` comes before the CUDA wrappers, which import it.
"""

from sfd2_torch.ops.nms import simple_nms
from sfd2_torch.ops.resize import resize_bilinear
from sfd2_torch.ops.grid_sample import grid_sample_bilinear, sample_at_points
from sfd2_torch.ops.extract import extract_keypoints
from sfd2_torch.ops.matching import (
    batch_matcher,
    mutual_nn_match,
    mutual_nn_match_tiled,
    mutual_nn_match_with_labels,
    mutual_nn_ratio_match,
    mutual_nn_ratio_match_tiled,
    nn_argmax,
    nn_top2,
    one_way_match,
    similarity_topk,
    tiled_route,
)
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_match_ratio import mutual_nn_ratio_match_cuda
from sfd2_torch.ops.cuda_nn_argmax import nn_argmax_cuda
from sfd2_torch.ops.cuda_nn_top2 import nn_top2_cuda
