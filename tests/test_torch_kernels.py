"""The port's CUDA kernels K1 (fused stem) and K2 (mutual-NN matcher).

On a CPU tensor each wrapper returns its plain version and counts no
launch; that part runs everywhere. The kernels themselves run only on an
NVIDIA GPU: those tests carry the ``cuda`` marker and skip without one.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (``--noconftest``: the suite's conftest
configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

On the card the plain versions run with TF32 off, so both sides compute
in float32. K1 is held to rel 1e-4 (float32 sums in another order over
27 + 576 terms); K2 to ≥ 99.9 % identical matches (only near-ties may
flip) and scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.matching import mutual_nn_match
from sfd2_torch.ops.stem import fused_stem_apply, repack_stem_params

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)


def _stem_packed(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: torch.randn(s, generator=g) * scale
    state = {"conv1a.0.weight": r(64, 3, 3, 3, scale=0.2), "conv1a.0.bias": r(64, scale=0.1),
             "conv1a.1.running_mean": r(64, scale=0.2),
             "conv1a.1.running_var": torch.exp(r(64, scale=0.3)),
             "conv1b.0.weight": r(64, 64, 3, 3, scale=0.1), "conv1b.0.bias": r(64, scale=0.1),
             "bn1b.0.running_mean": r(64, scale=0.1),
             "bn1b.0.running_var": torch.exp(r(64, scale=0.2))}
    return repack_stem_params(state)


def _unit(rng, *shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _pair(rng, b, n1, n2, c, invalid=0.1):
    """Half of desc1's rows are noisy copies of desc0 rows (real mutual
    matches), ~10 % of rows and columns invalid."""
    d0, d1 = _unit(rng, b, n1, c), _unit(rng, b, n2, c)
    m = min(n1, n2) // 2
    d1[:, :m] = d0[:, rng.permutation(n1)[:m]] + 0.3 * _unit(rng, b, m, c)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return d0, d1, rng.random((b, n1)) > invalid, rng.random((b, n2)) > invalid


@pytest.fixture
def cuda_device():
    """The card, with TF32 off so the plain versions compute in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_wrapper_on_cpu_returns_plain_result(out_dtype):
    packed = _stem_packed()
    x = torch.randn((2, 32, 48, 3), generator=torch.Generator().manual_seed(1))
    before = fused_stem_cuda.launches
    got = fused_stem_cuda(x, StemWeights(packed, "cpu"), out_dtype)
    assert fused_stem_cuda.launches == before  # the plain version is no launch
    assert got.dtype == out_dtype
    assert torch.equal(got, fused_stem_apply(x, packed).to(out_dtype))


def test_k1_wrapper_rejects_other_devices():
    x = torch.empty((1, 8, 8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_stem_cuda(x, StemWeights(_stem_packed(), "cpu"))


def test_k2_wrapper_on_cpu_returns_plain_result():
    d0, d1, v0, v1 = (torch.from_numpy(a) for a in _pair(np.random.default_rng(0), 2, 64, 80, 32))
    before = mutual_nn_match_cuda.launches
    got = mutual_nn_match_cuda(d0, d1, v0, v1)
    ref = mutual_nn_match(d0, d1, v0, v1)
    assert mutual_nn_match_cuda.launches == before  # the plain version is no launch
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_k2_wrapper_rejects_other_devices():
    d = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        mutual_nn_match_cuda(d, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 70, 138), (1, 64, 256), (1, 2, 2)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_plain_on_card(cuda_device, shape, out_dtype):
    """Ragged tiles (H/2, W/2 not multiples of 8), a batch, a 2×2 image."""
    sw = StemWeights(_stem_packed(), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((*shape, 3), generator=gen, device=cuda_device)
    ref = fused_stem_apply(x, sw.packed)
    before = fused_stem_cuda.launches
    got = fused_stem_cuda(x, sw, out_dtype)
    torch.cuda.synchronize()
    assert fused_stem_cuda.launches == before + 1
    assert got.dtype == out_dtype and got.shape == ref.shape
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= (1e-4 if out_dtype == torch.float32 else 8e-3), rel  # bf16: 2^-8 rounding


@pytest.mark.cuda
def test_k1_kernel_rejects_odd_sizes(cuda_device):
    sw = StemWeights(_stem_packed(), cuda_device)
    with pytest.raises(ValueError, match="even"):
        fused_stem_cuda(torch.zeros((1, 9, 8, 3), device=cuda_device), sw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n1,n2,c", [(3, 300, 1000, 128), (2, 5, 37, 64), (1, 129, 65, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain_on_card(cuda_device, b, n1, n2, c, dtype):
    """Ragged N1/N2 around the 128×64 tiles and a stride-0 (broadcast) query."""
    d0, d1, v0, v1 = _pair(np.random.default_rng(n1), b, n1, n2, c)
    q = torch.from_numpy(d0[:1]).to(cuda_device, dtype).expand(b, n1, c)
    bank = torch.from_numpy(d1).to(cuda_device, dtype)
    qv = torch.from_numpy(v0[:1]).to(cuda_device).expand(b, n1)
    bv = torch.from_numpy(v1).to(cuda_device)
    m_k, s_k = mutual_nn_match_cuda(q, bank, qv, bv)
    m_p, s_p = mutual_nn_match(q, bank, qv, bv)
    torch.cuda.synchronize()
    assert (m_k == m_p).float().mean().item() >= 0.999
    assert (s_k - s_p).abs().max().item() <= 1e-5
    assert (m_k >= 0).any()


@pytest.mark.cuda
def test_k2_kernel_all_invalid_bank_and_ties(cuda_device):
    """An all-invalid padding bank matches nothing and scores 0; duplicated
    query rows that tie on one column are both granted it."""
    rng = np.random.default_rng(3)
    d0, d1, _, _ = _pair(rng, 2, 128, 128, 128, invalid=0.0)
    d0[0, 70] = d0[0, 3]
    d1[0, 7] = d0[0, 3]
    q = torch.from_numpy(d0[:1]).to(cuda_device).expand(2, 128, 128)
    bank = torch.from_numpy(d1).to(cuda_device)
    bank[1] = 0.0
    qv = torch.ones((2, 128), dtype=torch.bool, device=cuda_device)
    bv = torch.ones((2, 128), dtype=torch.bool, device=cuda_device)
    bv[1] = False
    m_k, s_k = mutual_nn_match_cuda(q, bank, qv, bv)
    m_p, s_p = mutual_nn_match(q, bank, qv, bv)
    torch.cuda.synchronize()
    assert m_k[0, 3].item() == 7 and m_k[0, 70].item() == 7
    assert (m_k[1] == -1).all() and (s_k[1] == 0).all()
    assert torch.equal(m_k, m_p)
