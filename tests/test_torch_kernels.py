"""The port's CUDA kernels K1 (fused stem), K2 (mutual-NN matcher), K3
(row gather), K4 (mutual-NN + ratio matcher), K5 (bidirectional argmax) and
K6 (bidirectional top-2).

On a CPU tensor each wrapper returns its plain version and counts no
launch; that part runs everywhere. The kernels themselves run only on an
NVIDIA GPU: those tests carry the ``cuda`` marker and skip without one.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (``--noconftest``: the suite's conftest
configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

On the card the plain versions run with TF32 off, so both sides compute
in float32. K1 is held to rel 1e-4 (float32 sums in another order over
27 + 576 terms); K2 and K4 to ≥ 99.9 % identical matches (only near-ties
may flip) and scores within 1e-5; K3 exactly (a gather does no arithmetic);
K5 and K6 to ≥ 99.9 % identical indices and values within 1e-5, with exact
ties resolved by their contract (lowest index, multiset second value).
"""

import numpy as np
import pytest
import torch

from sfd2_torch.ops.cuda_gather import gather_rows_cuda
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_match_ratio import mutual_nn_ratio_match_cuda
from sfd2_torch.ops.cuda_nn_argmax import nn_argmax_cuda
from sfd2_torch.ops.cuda_nn_top2 import nn_top2_cuda
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.gather import gather_rows_plain
from sfd2_torch.ops.matching import mutual_nn_match, mutual_nn_ratio_match, nn_argmax, nn_top2
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
@pytest.mark.parametrize("b,n1,n2,c", [(3, 300, 1000, 128), (2, 5, 37, 64), (1, 129, 65, 4),
                                       (2, 300, 260, 512), (1, 200, 333, 320)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("broadcast", [False, True])
def test_k2_kernel_matches_plain_on_card(cuda_device, b, n1, n2, c, dtype, broadcast):
    """Ragged N1/N2 around the 128×128 tiles, distinct banks and a stride-0
    (broadcast) query; C padded to one 128-byte chunk or several (C = 4 is
    mostly padding; 320 and 512 are 10 and 16 f32 chunks)."""
    d0, d1, v0, v1 = _pair(np.random.default_rng(n1), b, n1, n2, c)
    if broadcast:
        q = torch.from_numpy(d0[:1]).to(cuda_device, dtype).expand(b, n1, c)
        qv = torch.from_numpy(v0[:1]).to(cuda_device).expand(b, n1)
    else:
        q = torch.from_numpy(d0).to(cuda_device, dtype)
        qv = torch.from_numpy(v0).to(cuda_device)
    bank = torch.from_numpy(d1).to(cuda_device, dtype)
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


@pytest.mark.cuda
def test_k2_shape_record_tells_the_layouts_apart(cuda_device):
    d0, d1, v0, v1 = _pair(np.random.default_rng(5), 2, 64, 64, 32)
    bank = torch.from_numpy(d1).to(cuda_device)
    q = torch.from_numpy(d0[:1]).to(cuda_device).expand(2, 64, 32)
    mutual_nn_match_cuda.shapes.clear()
    mutual_nn_match_cuda(q, bank)
    mutual_nn_match_cuda(torch.from_numpy(d0).to(cuda_device), bank)
    assert mutual_nn_match_cuda.shapes == {(2, 64, 64, 32, True): 1, (2, 64, 64, 32, False): 1}


def test_k3_wrapper_on_cpu_returns_plain_result():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(50, 9)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, 77).astype(np.int32))
    before = gather_rows_cuda.launches
    assert torch.equal(gather_rows_cuda(table, idx), gather_rows_plain(table, idx))
    assert gather_rows_cuda.launches == before  # the plain version is no launch


def test_k3_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported devices"):
        gather_rows_cuda(torch.empty((4, 3), device="meta"),
                         torch.empty(2, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 6, 8, 9, 16])
@pytest.mark.parametrize("idx_sorted", [False, True])
@pytest.mark.parametrize("n,m", [(300, 517), (1, 5), (70_000, 140_000), (8, 0)])
def test_k3_kernel_matches_plain_on_card(cuda_device, c, idx_sorted, n, m):
    """`idx_sorted`: the index order of the data (BA's point gathers read
    sorted indices); the kernel reads no hint of it."""
    rng = np.random.default_rng(c)
    table = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx = torch.from_numpy(np.sort(idx) if idx_sorted else idx).to(cuda_device)
    before = gather_rows_cuda.launches
    got = gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    assert gather_rows_cuda.launches == before + (m > 0)
    assert torch.equal(got, gather_rows_plain(table, idx))


@pytest.mark.cuda
def test_k3_kernel_rejects_what_it_does_not_take(cuda_device):
    table = torch.zeros((4, 17), device=cuda_device)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="outside"):
        gather_rows_cuda(table, idx)
    with pytest.raises(ValueError, match="dtypes"):
        gather_rows_cuda(table[:, :3].contiguous(), idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows_cuda(torch.zeros((3, 4), device=cuda_device).T, idx)


def test_k4_wrapper_on_cpu_returns_plain_result():
    d0, d1, v0, v1 = (torch.from_numpy(a) for a in _pair(np.random.default_rng(1), 2, 64, 80, 32))
    before = mutual_nn_ratio_match_cuda.launches
    got = mutual_nn_ratio_match_cuda(d0, d1, 0.9, v0, v1)
    ref = mutual_nn_ratio_match(d0, d1, 0.9, v0, v1)
    assert mutual_nn_ratio_match_cuda.launches == before  # the plain version is no launch
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_k4_wrapper_rejects_other_devices():
    d = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        mutual_nn_ratio_match_cuda(d, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n1,n2,c", [(3, 300, 1000, 128), (2, 5, 37, 64), (1, 129, 65, 4),
                                       (2, 1000, 300, 256), (2, 300, 260, 512),
                                       (1, 200, 333, 320)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("broadcast", [False, True])
def test_k4_kernel_matches_plain_on_card(cuda_device, b, n1, n2, c, dtype, broadcast):
    """Ragged N1/N2 around the 128×128 tiles, several row tiles (the column
    top-2 merge by the loser rule), distinct banks and a stride-0
    (broadcast) query; C padded to one 128-byte chunk or several."""
    d0, d1, v0, v1 = _pair(np.random.default_rng(n2), b, n1, n2, c)
    if broadcast:
        q = torch.from_numpy(d0[:1]).to(cuda_device, dtype).expand(b, n1, c)
        qv = torch.from_numpy(v0[:1]).to(cuda_device).expand(b, n1)
    else:
        q = torch.from_numpy(d0).to(cuda_device, dtype)
        qv = torch.from_numpy(v0).to(cuda_device)
    bank = torch.from_numpy(d1).to(cuda_device, dtype)
    bv = torch.from_numpy(v1).to(cuda_device)
    m_k, s_k = mutual_nn_ratio_match_cuda(q, bank, 0.9, qv, bv)
    m_p, s_p = mutual_nn_ratio_match(q, bank, 0.9, qv, bv)
    torch.cuda.synchronize()
    assert (m_k == m_p).float().mean().item() >= 0.999
    assert (s_k - s_p).abs().max().item() <= 1e-5
    assert (m_k >= 0).any()


@pytest.mark.cuda
def test_k4_kernel_column_tie_and_invalid_bank(cuda_device):
    """Rows 3 and 70 identical, their common best column a noisy copy: the
    column's top-2 is (s, s), so its ratio is ≈ 1 and neither row matches
    (without the duplicate, row 3 does). An all-invalid bank matches
    nothing and scores 0."""
    rng = np.random.default_rng(4)
    d0, d1, _, _ = _pair(rng, 2, 256, 256, 128, invalid=0.0)
    d1[0, 7] = d0[0, 3] + 0.1 * _unit(rng, 128)
    d1[0, 7] /= np.linalg.norm(d1[0, 7])
    bank = torch.from_numpy(d1).to(cuda_device)
    bank[1] = 0.0
    bv = torch.ones((2, 256), dtype=torch.bool, device=cuda_device)
    bv[1] = False
    single, _ = mutual_nn_ratio_match_cuda(torch.from_numpy(d0).to(cuda_device), bank, 0.9, None, bv)
    d0[0, 70] = d0[0, 3]
    q = torch.from_numpy(d0).to(cuda_device)
    m_k, s_k = mutual_nn_ratio_match_cuda(q, bank, 0.9, None, bv)
    m_p, _ = mutual_nn_ratio_match(q, bank, 0.9, None, bv)
    torch.cuda.synchronize()
    assert single[0, 3].item() == 7
    assert m_k[0, 3].item() == -1 and m_k[0, 70].item() == -1
    assert (m_k[1] == -1).all() and (s_k[1] == 0).all()
    assert torch.equal(m_k, m_p)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["match", "match_ratio"])
def test_k2_k4_builds_hold_wgmma(cuda_device, source):
    """K2 and K4 run on the tensor cores: their libraries hold wgmma
    (HGMMA in the SASS)."""
    from sfd2_torch.ops import cuda_build

    assert cuda_build.sass(source).count("HGMMA") > 0


NN_KERNELS = {"k5": (nn_argmax_cuda, nn_argmax, (1, 3)), "k6": (nn_top2_cuda, nn_top2, (1, 4))}


@pytest.mark.parametrize("kernel", sorted(NN_KERNELS))
def test_k5_k6_wrappers_on_cpu_return_plain_result(kernel):
    wrapper, plain, _ = NN_KERNELS[kernel]
    d0, d1, v0, v1 = (torch.from_numpy(a) for a in _pair(np.random.default_rng(2), 2, 64, 80, 32))
    before = wrapper.launches
    got, ref = wrapper(d0, d1, v0, v1), plain(d0, d1, v0, v1)
    assert wrapper.launches == before  # the plain version is no launch
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("kernel", sorted(NN_KERNELS))
def test_k5_k6_wrappers_reject_other_devices(kernel):
    d = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        NN_KERNELS[kernel][0](d, d)


def _agree(got, ref, index_slots, what):
    for k, (g, r) in enumerate(zip(got, ref)):
        if k in index_slots:
            assert g.dtype == torch.int32
            agree = (g == r).float().mean().item()
            assert agree >= 0.999, (what, k, agree)
        else:
            err = (g - r).abs().max().item()
            assert err <= 1e-5, (what, k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(NN_KERNELS))
@pytest.mark.parametrize("b,n1,n2,c", [(3, 300, 1000, 128), (2, 5, 37, 64), (1, 129, 65, 4),
                                       (2, 1000, 300, 512), (1, 640, 700, 132),
                                       (1, 2048, 2048, 512), (1, 4096, 4096, 128),
                                       (2, 384, 520, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("broadcast", [False, True])
def test_k5_k6_kernels_match_plain_on_card(cuda_device, kernel, b, n1, n2, c, dtype, broadcast):
    """Ragged N1/N2 around the 128×128 tiles (520 is not a multiple of
    128), C padded to one 128-byte chunk or several (132, 256, 512; C = 4
    is mostly padding), the main shapes [1, 2048, 512] and [1, 4096, 128],
    distinct banks and a stride-0 (broadcast) query."""
    wrapper, plain, index_slots = NN_KERNELS[kernel]
    d0, d1, v0, v1 = _pair(np.random.default_rng(n1 + c), b, n1, n2, c)
    if broadcast:
        q = torch.from_numpy(d0[:1]).to(cuda_device, dtype).expand(b, n1, c)
        qv = torch.from_numpy(v0[:1]).to(cuda_device).expand(b, n1)
    else:
        q = torch.from_numpy(d0).to(cuda_device, dtype)
        qv = torch.from_numpy(v0).to(cuda_device)
    bank = torch.from_numpy(d1).to(cuda_device, dtype)
    bv = torch.from_numpy(v1).to(cuda_device)
    before = wrapper.launches
    got = wrapper(q, bank, qv, bv)
    ref = plain(q, bank, qv, bv)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _agree(got, ref, index_slots, (kernel, b, n1, n2, c, dtype, broadcast))


@pytest.mark.cuda
def test_k5_k6_kernels_resolve_ties_by_the_contract(cuda_device):
    """Query rows 3 and 200 identical with bank column 7 their copy (a column
    tie), bank columns 9 and 150 identical with query row 40 their copy (a
    row tie), in different tiles and row blocks: the lowest index wins both
    ways and each tied max is also its second value. Row 5 is invalid and
    bank 1 all invalid."""
    rng = np.random.default_rng(6)
    d0, d1, _, _ = _pair(rng, 2, 256, 256, 128, invalid=0.0)
    d0[0, 200] = d0[0, 3]
    d1[0, 7] = d0[0, 3]
    d1[0, 150] = d1[0, 9]
    d0[0, 40] = d1[0, 9]
    q, bank = torch.from_numpy(d0).to(cuda_device), torch.from_numpy(d1).to(cuda_device)
    qv = torch.ones((2, 256), dtype=torch.bool, device=cuda_device)
    qv[0, 5] = False
    bv = torch.ones((2, 256), dtype=torch.bool, device=cuda_device)
    bv[1] = False
    m12, nn12, m21, nn21 = nn_argmax_cuda(q, bank, qv, bv)
    t = nn_top2_cuda(q, bank, qv, bv)
    torch.cuda.synchronize()
    assert nn12[0, 3] == 7 and nn12[0, 200] == 7 and nn21[0, 7] == 3
    assert nn12[0, 40] == 9 and nn21[0, 9] == 40 and nn21[0, 150] == 40
    assert t[1][0, 40] == 9 and t[2][0, 40] == t[0][0, 40]  # row tie: 2nd == max
    assert t[4][0, 7] == 3 and t[5][0, 7] == t[3][0, 7]     # column tie: 2nd == max
    assert (m12[1] < -5e8).all() and (m21[0] > -5e8).all()  # invalid bank / one invalid row
    for got, ref in (((m12, nn12, m21, nn21), nn_argmax(q, bank, qv, bv)),
                     (t, nn_top2(q, bank, qv, bv))):
        for g, r in zip(got, ref):
            assert torch.equal(g, r) if g.dtype == torch.int32 else (g - r).abs().max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nnm", "nnr"])
def test_batch_matcher_takes_d2net_width_on_card(cuda_device, mode):
    """D2-Net's 512-wide descriptors below the large-bank threshold go to
    K2 / K4, which take them and return the plain result."""
    from sfd2_torch.ops.matching import batch_matcher, tiled_route

    assert not tiled_route(2048, 512)
    d0, d1, v0, v1 = (torch.from_numpy(a).to(cuda_device)
                      for a in _pair(np.random.default_rng(7), 1, 2048, 2048, 512))
    kernel = mutual_nn_match_cuda if mode == "nnm" else mutual_nn_ratio_match_cuda
    before = kernel.launches
    m_k, s_k = batch_matcher(mode, 0.9)(d0, d1, v0, v1)
    m_p, s_p = batch_matcher(mode, 0.9)(d0.cpu(), d1.cpu(), v0.cpu(), v1.cpu())
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert (m_k.cpu() == m_p).float().mean().item() >= 0.999
    assert (s_k.cpu() - s_p).abs().max().item() <= 1e-5
    assert (m_k >= 0).any()
