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
K3 is also held inside a CUDA graph, and bundle adjustment, which replays
its LM iteration from one, to the same iteration stepped eagerly on the
card within 1e-4; two runs of ``bundle_adjust`` give the same bits (its
sums run in one fixed order, ``sfm/ba.py::SegmentPlan``). The localization programs (PnP-RANSAC, the refinement, LM)
replayed from their CUDA graphs must equal the same programs run eagerly
on the card, be captured once per key, and give the sequential results
when four threads replay them. ``Extractor.extract_batch`` on numpy
images, copied to the card as floats and rounded there, must give the
features of the same images passed as tensors on the card.
"""

import numpy as np
import pytest
import torch

from sfd2_torch.cli.extract_features import seeded_state_dict
from sfd2_torch.ops.cuda_gather import (count_graph_replays, gather_rows_cuda,
                                        graph_capture_record)
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_match_ratio import mutual_nn_ratio_match_cuda
from sfd2_torch.ops.cuda_nn_argmax import nn_argmax_cuda
from sfd2_torch.ops.cuda_nn_top2 import nn_top2_cuda
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.gather import gather_rows_plain
from sfd2_torch.ops.matching import mutual_nn_match, mutual_nn_ratio_match, nn_argmax, nn_top2
from sfd2_torch.ops.stem import fused_stem_apply, repack_stem_params
from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor
from sfd2_torch.utils import profiling

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
@pytest.mark.parametrize("shape", [(2, 70, 138), (1, 64, 256), (1, 2, 2), (1, 18, 34),
                                   (3, 30, 62), (1, 112, 96)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_plain_on_card(cuda_device, shape, out_dtype):
    """Ragged 8 × 16 tiles (H/2 or W/2 not multiples of 8 and 16, one
    column or row past a tile), a batch, a 2×2 image, whole tiles."""
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
def test_k1_build_holds_wgmma(cuda_device):
    """K1's conv1b runs on the tensor cores: its library holds wgmma
    (HGMMA in the SASS)."""
    from sfd2_torch.ops import cuda_build

    assert cuda_build.sass("stem").count("HGMMA") > 0


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
def test_k3_replayed_from_a_cuda_graph_counts_each_replay(cuda_device):
    """K3 captured in a CUDA graph reads the table where it lies at replay
    time: overwritten in place, each replay equals the plain gather of the
    new values, and each replay counts one launch of its shape."""
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.normal(size=(500, 6)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 500, 3000).astype(np.int32)).to(cuda_device)
    gather_rows_cuda(table, idx)  # loads the library before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    before, shapes_before = gather_rows_cuda.launches, dict(gather_rows_cuda.shapes)
    with torch.cuda.stream(stream), graph_capture_record() as captured:
        graph.capture_begin()
        out = gather_rows_cuda(table, idx)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    assert captured == {(500, 3000, 6): 1}
    assert gather_rows_cuda.launches == before and dict(gather_rows_cuda.shapes) == shapes_before
    for k in range(3):
        table.copy_(torch.from_numpy(rng.normal(size=(500, 6)).astype(np.float32)))
        graph.replay()
        count_graph_replays(captured)
        torch.cuda.synchronize()
        assert torch.equal(out, gather_rows_plain(table, idx))
        assert gather_rows_cuda.launches == before + k + 1
        assert gather_rows_cuda.shapes[(500, 3000, 6)] == shapes_before.get((500, 3000, 6), 0) + k + 1


def _ba_problem(device, rng, n_cams=6, n_pts=120, noise=0.2):
    """The problem of tests/test_ba.py::build_problem (6 cameras, 120 points,
    a pinhole camera, cameras 0 and 1 fixed, the others and the points
    perturbed), built with numpy alone: that file imports jax."""
    from scipy.spatial.transform import Rotation

    from sfd2_torch.sfm.ba import BAProblem

    cam = np.array([500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 14, n_pts)], 1)
    rots = [Rotation.from_rotvec(rng.normal(size=3) * 0.05) for _ in range(n_cams)]
    ts = [-r.as_matrix() @ np.array([i * 0.8 - 2.0, 0, 0]) for i, r in enumerate(rots)]
    obs_xy, obs_cam, obs_pt = [], [], []
    for ci, (r, t) in enumerate(zip(rots, ts)):
        pc = pts @ r.as_matrix().T + t
        xy = cam[:2] * pc[:, :2] / pc[:, 2:] + cam[2:4]
        ok = (pc[:, 2] > 0) & (xy[:, 0] > 0) & (xy[:, 0] < 640) & (xy[:, 1] > 0) & (xy[:, 1] < 480)
        for pi in np.nonzero(ok)[0]:
            obs_xy.append(xy[pi] + rng.normal(size=2) * noise)
            obs_cam.append(ci)
            obs_pt.append(pi)
    quat = lambda r: r.as_quat()[[3, 0, 1, 2]]  # noqa: E731  (w, x, y, z)
    q_init = np.array([quat(r) for r in rots], np.float32)
    t_init = np.array(ts, np.float32)
    for ci in range(2, n_cams):
        q_init[ci] = quat(Rotation.from_rotvec(rng.normal(size=3) * 0.01)
                          * Rotation.from_quat(q_init[ci][[1, 2, 3, 0]]))
        t_init[ci] += rng.normal(size=3) * 0.05
    p_init = (pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return BAProblem(obs_xy=f32(obs_xy),
                     obs_cam=torch.as_tensor(obs_cam, dtype=torch.int32, device=device),
                     obs_point=torch.as_tensor(obs_pt, dtype=torch.int32, device=device),
                     obs_w=torch.ones(len(obs_xy), device=device), qvecs=f32(q_init),
                     tvecs=f32(t_init), cam_params=f32(np.tile(cam, (n_cams, 1))),
                     points=f32(p_init), fixed_cams=torch.as_tensor(fixed, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("lm_iters,cg_iters", [(6, 15), (2, 8), (1, 5)])
def test_bundle_adjust_graph_matches_eager_iteration_on_card(cuda_device, lm_iters, cg_iters):
    """On the card ``bundle_adjust`` runs one LM iteration eagerly and
    replays the rest from a CUDA graph: within 1e-4 of the same iteration
    function stepped eagerly, with K3's launches counted alike; a second
    run gives the same bits."""
    from sfd2_torch.sfm import ba

    problem = _ba_problem(cuda_device, np.random.default_rng(0))
    replays, captures = profiling.counter("ba.replays"), profiling.counter("ba.captures")
    before = gather_rows_cuda.launches
    got = ba.bundle_adjust(problem, lm_iters=lm_iters, cg_iters=cg_iters)
    torch.cuda.synchronize()
    graph_launches = gather_rows_cuda.launches - before
    assert profiling.counter("ba.replays") - replays == max(lm_iters - 1, 0)
    assert profiling.counter("ba.captures") - captures == int(lm_iters >= 2)
    iterate, state = ba.lm_setup(problem, cg_iters=cg_iters)
    for _ in range(lm_iters):
        state = iterate(state)
    ref = ba.lm_result(state)
    torch.cuda.synchronize()
    assert gather_rows_cuda.launches - before - graph_launches == graph_launches
    assert graph_launches == 5 + lm_iters * (9 + 2 * cg_iters)
    assert float(got.final_cost) < float(got.initial_cost)
    for name in ("initial_cost", "final_cost"):
        a, b = float(getattr(got, name)), float(getattr(ref, name))
        assert abs(a - b) <= 1e-4 * abs(b), (name, a, b)
    sign = torch.sign(torch.sum(got.qvecs * ref.qvecs, dim=1, keepdim=True))
    assert (got.qvecs * sign - ref.qvecs).abs().max().item() <= 1e-4
    assert (got.tvecs - ref.tvecs).abs().max().item() <= 1e-4
    assert (got.points - ref.points).abs().max().item() <= 1e-4
    again = ba.bundle_adjust(problem, lm_iters=lm_iters, cg_iters=cg_iters)
    for name, a, b in zip(got._fields, got, again):
        assert torch.equal(a, b), name


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


def _pnp_batch(device, rng, q_n=3, n=256, outliers=0.3, noise=0.3):
    """Q scenes of 2D-3D matches with some outliers and padding rows, made
    with the port's own projection: (xy, pts, cams, valid, true (q, t))."""
    from sfd2_torch.geometry.cameras import project_points

    cam = np.array([520.0, 515.0, 320.0, 240.0, -0.05, 0.01, 5e-4, -2e-4], np.float32)
    xy = np.zeros((q_n, n, 2), np.float32)
    pts = np.zeros((q_n, n, 3), np.float32)
    valid = np.zeros((q_n, n), bool)
    poses = []
    for i in range(q_n):
        m = int(n * rng.uniform(0.5, 0.9))
        p = np.stack([rng.uniform(-3, 3, m), rng.uniform(-2, 2, m), rng.uniform(5, 12, m)], 1)
        q = np.array([0.99, 0.05 * rng.normal(), 0.05 * rng.normal(), 0.03])
        q = (q / np.linalg.norm(q)).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32) * 0.3
        proj = project_points(torch.from_numpy(p.astype(np.float32)), torch.from_numpy(q),
                              torch.from_numpy(t), torch.from_numpy(cam))[0].numpy()
        proj = proj + rng.normal(size=proj.shape) * noise
        bad = rng.random(m) < outliers
        proj[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
        xy[i, :m], pts[i, :m], valid[i, :m] = proj, p, True
        poses.append((q, t))
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(xy), t(pts), t(np.tile(cam, (q_n, 1))), t(valid), poses


def _programs(device, rng, q_n=3, n=256, h=128):
    """A PnP-RANSAC and a refinement program on one batch."""
    from sfd2_torch.localization.pnp import refine_pose_iterative_program
    from sfd2_torch.localization.ransac import pnp_ransac_program, sample_minimal_sets

    xy, pts, cams, valid, poses = _pnp_batch(device, rng, q_n, n)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in rng.integers(0, 1 << 30, q_n)]
    idx = sample_minimal_sets(valid, h, gens)
    q0 = torch.tensor(np.stack([q for q, _ in poses]), device=device)
    t0 = torch.tensor(np.stack([t for _, t in poses]), device=device) + 0.05
    return (pnp_ransac_program(xy, pts, cams, valid, idx, 4.0),
            refine_pose_iterative_program(q0, t0, pts, xy, cams, valid, 6.0, iters=3))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pnp", "refine"])
def test_localization_graph_matches_eager_on_card(cuda_device, kind):
    """A PnP-RANSAC or refinement program replayed from its CUDA graphs
    equals the same program run eagerly on the card: identical counts and
    inlier masks, poses within 1e-5."""
    from sfd2_torch.localization import graphs

    prog = _programs(cuda_device, np.random.default_rng(1))[kind == "refine"]
    got, ref = graphs.run(prog), graphs.run_eager(prog)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 7:], ref[:, 7:])  # counts, flags, masks / per-iteration support
    assert (got[:, :7] - ref[:, :7]).abs().max().item() <= 1e-5
    assert (got[:, 7] > 50).all()  # real support in every query


@pytest.mark.cuda
def test_localization_graphs_captured_once_per_key_on_card(cuda_device):
    """One capture per key (program, shapes): later calls with new data and
    another threshold replay; a new padded size captures anew."""
    from sfd2_torch.localization import graphs
    from sfd2_torch.localization.ransac import pnp_ransac_core, sample_minimal_sets

    rng = np.random.default_rng(2)
    captures, replays = profiling.counter("graphs.captures"), profiling.counter("graphs.replays")
    for i, (n, thresh) in enumerate(((320, 4.0), (320, 6.0), (320, 3.0), (640, 4.0))):
        xy, pts, cams, valid, poses = _pnp_batch(cuda_device, rng, 2, n)
        gens = [torch.Generator(device=cuda_device).manual_seed(i * 10 + j) for j in range(2)]
        res = pnp_ransac_core(xy, pts, cams, valid, sample_minimal_sets(valid, 96, gens),
                              threshold=thresh)
        assert bool(res.success.all())
        # 3 graph segments each
        assert profiling.counter("graphs.captures") - captures == (3 if n == 320 else 6)
        assert profiling.counter("graphs.replays") - replays == 3 * (i + 1)
    keys = [k for k in graphs.captured_keys() if k[0][0] == "pnp"]
    assert len({k[2][0][0] for k in keys}) >= 2


@pytest.mark.cuda
def test_localization_graphs_replayed_from_four_threads_on_card(cuda_device):
    """Four threads replaying the same graphs give the sequential results."""
    from concurrent.futures import ThreadPoolExecutor

    from sfd2_torch.localization import graphs

    rng = np.random.default_rng(3)
    progs = [p for _ in range(4) for p in _programs(cuda_device, rng, q_n=2, n=192, h=64)]
    seq = [graphs.run(p) for p in progs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        par = list(pool.map(graphs.run, progs * 2))
    torch.cuda.synchronize()
    for a, b in zip(seq * 2, par):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_refine_pose_lm_runs_from_a_graph_on_card(cuda_device):
    """``refine_pose_lm`` on CUDA tensors replays a captured graph and
    agrees with its CPU run."""
    from sfd2_torch.localization import graphs
    from sfd2_torch.localization.pnp import refine_pose_lm

    xy, pts, cams, valid, poses = _pnp_batch(cuda_device, np.random.default_rng(4), 3, 200,
                                             outliers=0.0)
    q0 = torch.tensor(np.stack([q for q, _ in poses]), device=cuda_device)
    t0 = torch.tensor(np.stack([t for _, t in poses]), device=cuda_device) + 0.05
    args = (q0, t0, pts, xy, cams, valid.float())
    before = profiling.counter("graphs.replays")
    q, t = refine_pose_lm(*args)
    torch.cuda.synchronize()
    assert profiling.counter("graphs.replays") == before + 1
    q_c, t_c = refine_pose_lm(*(a.cpu() for a in args))
    assert (q.cpu() - q_c).abs().max().item() <= 1e-4
    assert (t.cpu() - t_c).abs().max().item() <= 1e-4
    assert (t.cpu() - torch.tensor(np.stack([t for _, t in poses]))).abs().max().item() <= 0.02


@pytest.mark.cuda
def test_extract_batch_rounds_numpy_images_on_card(cuda_device):
    """Numpy images copied to the card as floats and rounded there: over
    three calls whose buckets shrink and then grow, the padded uint8 batch
    equals the host's rounding, the features equal bit for bit those of
    the same images passed as tensors on the card (the resized scales'
    branch), and ``extract.device_rounds`` counts each call's numpy
    images."""
    ex = Extractor(seeded_state_dict(0), ExtractionConfig(max_keypoints=256), device=cuda_device)
    rng = np.random.default_rng(7)
    for shapes in ([(200, 260), (150, 300), (180, 90)], [(60, 80), (64, 64)],
                   [(420, 500), (300, 520), (100, 100), (410, 90), (50, 40)]):
        images = [np.kron(rng.random((-(-h // 8), -(-w // 8), 3)), np.ones((8, 8, 1)))[:h, :w]
                  .astype(np.float32) for h, w in shapes]
        images[-1] = images[-1].astype(np.float64)
        batch, (hp, wp) = ex._pad_batch(images)
        want = np.zeros((len(images), hp, wp, 3), np.uint8)
        for i, im in enumerate(images):
            want[i, : im.shape[0], : im.shape[1]] = np.clip(np.rint(im * 255.0), 0, 255)
        np.testing.assert_array_equal(batch.cpu().numpy(), want)
        before = profiling.counter("extract.device_rounds")
        got = ex.extract_batch(images)
        assert profiling.counter("extract.device_rounds") - before == len(images)
        ref = ex.extract_batch([torch.from_numpy(im).to(cuda_device) for im in images])
        for g, r in zip(got, ref):
            assert len(g.keypoints) > 0
            for a, b in zip(g[:4], r[:4]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_graph_capture_when_the_allocator_cache_holds_the_card(cuda_device):
    """A capture in a process whose caching allocator holds nearly all of
    the card in freed blocks of the graphs' stream still finds memory.
    The program's eager run fits in those blocks, so nothing hands them
    back before the capture, and the capture's own pool needs fresh
    memory, which the allocator cannot free while a capture runs:
    ``release_cache_for_capture`` hands the cache back first."""
    from sfd2_torch.localization import graphs

    n = 3 << 27  # float32: 1.5 GiB, the size of each of the program's tensors

    def fill(inputs, state):  # eager, on the graphs' stream: blocks freed on return
        blocks = []
        while torch.cuda.mem_get_info(inputs[0].device)[0] >= 4 * n:
            blocks.append(torch.empty(n, device=inputs[0].device))
        return (inputs[0] + len(blocks),)

    def seg(inputs, state):
        return (inputs[0] + torch.ones(n, device=inputs[0].device),)

    zero = torch.zeros(1, device=cuda_device)
    assert float(graphs.run(graphs.Program(("fill_cache", n), ((False, fill),), (zero,)))) > 0
    out = graphs.run(graphs.Program(("cache_held", n), ((True, seg),), (zero,)))
    assert out.shape == (n,) and float(out.min()) == float(out.max()) == 1.0
