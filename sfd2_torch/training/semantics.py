"""ADE20k semantic-class → stability mapping (data tables).

Port of ``sfd2_tpu/training/semantics.py`` (``nets/semseg/utils.py`` +
``object150_info_ext.csv``): each of the 150 ADE20k classes maps to a
coarse stability category {0 invalid, 1 stable, 2 dynamic, 3 short-term},
and categories map to confidences {0: 0.1, 1: 1.0, 2: 0.1, 3: 0.5}
(``utils.py:31-49``). The port keeps its own copy of the table (classes
1-indexed as in ADE20k; index 0 is a padding slot treated as invalid).
"""

from __future__ import annotations

import numpy as np
import torch

from sfd2_torch.utils.device import to_device

# Stability category per ADE20k class id 1..150 (csv Label column).
_ADE20K_STABILITY = np.array(
    [0]  # class id 0: unused / unlabeled → invalid
    + [
        1, 1, 0, 1, 3, 1, 1, 1, 1, 3,
        1, 1, 2, 1, 1, 1, 0, 3, 0, 1,
        2, 0, 1, 1, 1, 1, 0, 0, 0, 0,
        1, 1, 1, 1, 1, 1, 1, 0, 1, 1,
        1, 1, 1, 1, 1, 1, 0, 0, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        0, 1, 1, 1, 1, 1, 3, 1, 0, 0,
        1, 1, 0, 1, 1, 1, 2, 1, 1, 1,
        2, 1, 0, 0, 1, 1, 1, 1, 1, 1,
        2, 0, 1, 1, 0, 1, 1, 1, 1, 1,
        1, 1, 2, 2, 0, 1, 1, 1, 1, 0,
        1, 1, 1, 0, 1, 1, 2, 1, 1, 1,
        2, 1, 1, 1, 1, 1, 2, 2, 0, 1,
        1, 1, 1, 2, 1, 1, 1, 1, 1, 2,
        1, 1, 1, 1, 1, 0, 1, 1, 1, 1,
    ],
    dtype=np.int32,
)

# Category → confidence (``get_conf_dict``).
_CATEGORY_CONF = np.array([0.1, 1.0, 0.1, 0.5], dtype=np.float32)


def stability_category(seg_labels: torch.Tensor) -> torch.Tensor:
    """ADE20k class map [...] (int, 1..150; 0 = unlabeled) → category map."""
    table = to_device(_ADE20K_STABILITY, seg_labels.device)
    return table[seg_labels.long().clamp(0, len(_ADE20K_STABILITY) - 1)]


def semantic_to_confidence(seg_labels: torch.Tensor) -> torch.Tensor:
    """Class map → confidence map in {0.1, 0.5, 1.0}
    (``segmantic_to_confidence``, ``utils.py:70``)."""
    conf = to_device(_CATEGORY_CONF, seg_labels.device)
    return conf[stability_category(seg_labels).long()]


def confidence_to_class(conf: torch.Tensor) -> torch.Tensor:
    """Confidence {0.1, 0.5, 1.0} → 3-class stability target {0, 1, 2}
    (``nets/losses.py:420-423``)."""
    cls = torch.full(conf.shape, 2, dtype=torch.int64, device=conf.device)
    cls = torch.where((conf - 0.1).abs() < 1e-6, 0, cls)
    return torch.where((conf - 0.5).abs() < 1e-6, 1, cls)
