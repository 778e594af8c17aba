"""Two-view F-RANSAC's route (``sfm/twoview.py``), its CUDA kernels
(``ops/cuda_twoview.py``, ``csrc/twoview.cu``) and the spans of
``sfm/pipeline.py::geometric_verification``.

On the CPU: CPU and float64 inputs take the plain version and are counted
as plain batches; ``geometric_verification`` records one ``verify.batch``
per group with ``verify.prep``, ``verify.ransac`` and ``verify.fetch``
inside it and counts every hypothesis; it reaches F-RANSAC through the
module global ``pipeline.verify_fundamental_ransac``, which the benchmark's
controls replace; the kernel's wrapper refuses what it does not take.

On the CPU, too, the local optimisation's rule
(``utils/twoview_parity.py``) passes the plain version summing in another
order and fails it with its steps skipped, hard weights or three steps.

On the card (``cuda`` marker; skipped without one), on seeded synthetic pairs
with 5–30 % outliers and the same samples fed to both versions, by the rules
of ``utils/twoview_parity.py``: every hypothesis' MSAC within a quarter of the
plain version's own float32 gap to float64 from the plain version's, and as
near float64 as the plain version (medians and 90th percentiles), at least a
quarter within 1e-4. A bound of 1e-4 on every hypothesis cannot hold: the
float32 fit is decided by rounding in its rank-2 projection, so two float32
summation orders part by a median ~0.1 % and at the tail by tens of percent.
Then the same ``success`` on every pair, inlier decisions as near the planted
truth as the plain version's (within 0.02 over 40 pairs) and masks equal on at
least 90 % of the matches; the local optimisation alone from a given F, in
normalised coordinates where it improves every pair, as near float64 as the
plain version within a factor of 3; edge shapes (one pair, a partial batch, N
not a multiple of 32, N above the 1,024-match tile and above 8,192 matches,
random masks, a pair with fewer than 8 valid matches); the route by dtype and
mask on the card; the in-kernel sampler (8 distinct valid positions, equal to
a numpy model of its Philox draw, positions uniform by a chi-square test); the
same bits from the same generator seed.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_twoview_kernel.py -q
"""

import math

import numpy as np
import pytest
import torch

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore
from sfd2_torch.ops import cuda_twoview
from sfd2_torch.sfm import pipeline
from sfd2_torch.sfm import twoview
from sfd2_torch.sfm.pipeline import TriangulationConfig, geometric_verification
from sfd2_torch.utils import profiling
from sfd2_torch.utils import twoview_parity
from sfd2_torch.utils.synth import two_view_pairs

torch.set_num_threads(2)

THR = 4.0


@pytest.fixture
def cuda_device():
    """The card, with TF32 off so the plain version computes in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def pairs(rng, b: int, n: int, **kw):
    """``utils/synth.py::two_view_pairs`` as torch tensors."""
    return tuple(torch.from_numpy(a) for a in two_view_pairs(rng, b, n, **kw))


# --- the route and the spans, on the CPU -----------------------------------


def _counts():
    return {k: profiling.counter(f"twoview.{k}")
            for k in ("kernel_batches", "plain_batches", "hypotheses")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("entry", ["sampled", "core"])
def test_cpu_inputs_take_the_plain_route(dtype, entry):
    xy1, xy2, valid, _ = pairs(np.random.default_rng(1), 3, 96)
    xy1, xy2 = xy1.to(dtype), xy2.to(dtype)
    gen = torch.Generator().manual_seed(2)
    before = _counts()
    launches = cuda_twoview.ransac.launches
    if entry == "sampled":
        got = twoview.verify_fundamental_ransac(xy1, xy2, valid, THR, gen, num_hypotheses=512)
        idx = twoview.sample_eight(valid, 512, torch.Generator().manual_seed(2))
    else:
        idx = twoview.sample_eight(valid, 512, gen)
        got = twoview.verify_fundamental_ransac_core(xy1, xy2, valid, idx, THR)
    ref = twoview.verify_fundamental_ransac_plain(xy1, xy2, valid, idx, THR)
    after = _counts()
    assert after == {"kernel_batches": before["kernel_batches"],
                     "plain_batches": before["plain_batches"] + 1,
                     "hypotheses": before["hypotheses"] + 3 * 512}
    assert cuda_twoview.ransac.launches == launches
    assert torch.equal(got.inliers, ref.inliers) and torch.equal(got.success, ref.success)
    assert got.fmatrix.dtype == dtype and bool(got.success.all())


def test_the_kernel_wrapper_refuses_what_it_does_not_take():
    xy1, xy2, valid, _ = pairs(np.random.default_rng(3), 2, 32)
    key = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_twoview.ransac(xy1, xy2, valid, THR, 15, 0.1, key=key, num_hypotheses=8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_twoview.refine(xy1, xy2, valid, torch.eye(3).expand(2, 3, 3), THR, 15, 0.1)
    assert not twoview._kernel_route(xy1, xy2)


def test_a_mask_that_is_not_bool_is_taken_as_bool():
    xy1, xy2, valid, _ = pairs(np.random.default_rng(6), 3, 128, mask=0.8)
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    ref = twoview.verify_fundamental_ransac(xy1, xy2, valid, THR, gen(), num_hypotheses=256)
    got = twoview.verify_fundamental_ransac(xy1, xy2, valid.to(torch.uint8), THR, gen(),
                                            num_hypotheses=256)
    assert got.inliers.dtype == torch.bool
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _plain_refine(kind):
    """``cuda_twoview.refine``'s result [4] (the MSAC after the local
    optimisation) by the plain version, summing over the matches in another
    order; ``kind`` breaks it: no steps, hard weights or three steps."""
    def refine(xy1, xy2, valid, f, threshold, min_inliers, min_inlier_ratio):
        thr2 = threshold * threshold
        perm = torch.randperm(xy1.shape[1], generator=torch.Generator().manual_seed(3))
        xy1, xy2, valid = xy1[:, perm], xy2[:, perm], valid[:, perm]
        cur = twoview._msac(f, xy1, xy2, valid, thr2)
        for _ in range({"none": 0, "three": 3}.get(kind, 4)):
            e = twoview.sampson_error(f, xy1, xy2)
            w = 1.0 if kind == "hard" else 1.0 / (1.0 + e / thr2)
            w = torch.where((e <= thr2) & valid, w, 0.0)
            f_ls = twoview._fit_fundamental_lanes(xy1, xy2, w)
            ok = torch.isfinite(f_ls).flatten(-2).all(-1)
            cand = torch.where(ok, twoview._msac(f_ls, xy1, xy2, valid, thr2), torch.inf)
            f = torch.where((cand < cur)[:, None, None], f_ls, f)
            cur = torch.minimum(cand, cur)
        return None, None, None, None, cur
    return refine


@pytest.mark.parametrize("kind", ["another_order", "none", "hard", "three"])
def test_the_local_optimisation_rule_tells_a_broken_refit(kind):
    """The rule the card holds ``twoview_refine`` to, against the plain
    version: another summation order passes; a refine that skipped its
    steps, weighted inliers 1 or took 3 steps fails."""
    case = twoview_parity.lo_case(np.random.default_rng(21), 128, 1024)
    fails = twoview_parity.lo_failures(twoview_parity.lo_gaps(*case, refine=_plain_refine(kind)))
    assert (fails == []) == (kind == "another_order"), fails


def _store_scene(rng, n_images=4, n_points=300):
    """Images of one 3D point set (keypoint k of every image is point k) and
    the NNM-like matches of every pair: 80 % of the points matched, 15 %
    of those to a wrong keypoint."""
    pts = np.stack([rng.uniform(-3, 3, n_points), rng.uniform(-2, 2, n_points),
                    rng.uniform(4, 12, n_points)], 1)
    feats, matches = FeatureStore(), MatchStore()
    names = [f"img{i}.jpg" for i in range(n_images)]
    for i, name in enumerate(names):
        kp = 800.0 * (pts[:, :2] + [0.3 * i, 0.0]) / pts[:, 2:] + [512.0, 384.0]
        kp = (kp + rng.normal(0, 0.5, kp.shape)).astype(np.float32)
        feats.write(name, ImageFeatures(kp, np.zeros((n_points, 8), np.float32),
                                        np.ones(n_points, np.float32), np.array([1024, 768])))
    pair_list = [(names[i], names[j]) for i in range(n_images) for j in range(i + 1, n_images)]
    for a, b in pair_list:
        m = np.where(rng.random(n_points) < 0.8, np.arange(n_points), -1)
        wrong = (m >= 0) & (rng.random(n_points) < 0.15)
        m[wrong] = rng.integers(0, n_points, int(wrong.sum()))
        matches.write(a, b, m.astype(np.int32), np.ones(n_points, np.float32))
    return feats, matches, pair_list


def test_geometric_verification_records_its_spans_and_hypotheses():
    feats, matches, pair_list = _store_scene(np.random.default_rng(4))
    cfg = TriangulationConfig(verify_batch=4)
    before = _counts()
    with profiling.recording() as recs:
        verified = geometric_verification(feats, matches, pair_list, cfg, max_matches=256,
                                          device="cpu")
    after = _counts()
    batches = [r for r in recs if r.name == "verify.batch"]
    sizes = [len(pair_list[i:i + 4]) for i in range(0, len(pair_list), 4)]
    assert [r.tags["pairs"] for r in batches] == sizes
    assert all(0 < r.tags["matches"] <= r.tags["pairs"] * 256 for r in batches)
    for r in batches:
        kids = [c for c in recs if c.parent == r.id]
        assert [c.name for c in kids] == ["verify.prep", "verify.ransac", "verify.fetch"]
        assert all(r.t0 <= c.t0 <= c.t1 <= r.t1 for c in kids)
        assert kids[1].tags == {"hypotheses": r.tags["pairs"] * 2048}
    assert after["hypotheses"] - before["hypotheses"] == len(pair_list) * 2048
    assert after["plain_batches"] - before["plain_batches"] == len(sizes)
    assert after["kernel_batches"] == before["kernel_batches"]
    assert len(verified) == len(pair_list)
    for _, _, m in verified:  # the true matches kept, the wrong ones dropped
        assert (m[:, 0] == m[:, 1]).mean() > 0.97 and len(m) > 150


def test_geometric_verification_calls_the_module_global(monkeypatch):
    """The benchmark's ``few16`` control swaps ``pipeline.verify_fundamental_ransac``;
    the stand-in must be what runs."""
    feats, matches, pair_list = _store_scene(np.random.default_rng(5), n_images=3)
    calls = []

    def stand_in(xy1, xy2, valid, threshold=4.0, generator=None, num_hypotheses=2048,
                 min_inliers=15, min_inlier_ratio=0.1):
        calls.append((tuple(xy1.shape), threshold, generator.initial_seed()))
        b = valid.shape[0]
        keep = valid & (torch.arange(valid.shape[1]) % 2 == 0)
        return twoview.TwoViewResult(torch.zeros(b, 3, 3), keep, keep.sum(-1).int(),
                                     torch.ones(b, dtype=torch.bool))

    monkeypatch.setattr(pipeline, "verify_fundamental_ransac", stand_in)
    verified = geometric_verification(feats, matches, pair_list,
                                      TriangulationConfig(verify_batch=2), max_matches=128,
                                      device="cpu")
    assert calls == [((2, 128, 2), 4.0, 0), ((1, 128, 2), 4.0, 2)]
    assert len(verified) == 3
    for (a, b), (n0, n1, m) in zip(pair_list, verified):
        src = np.nonzero(matches.read(a, b)[0] >= 0)[0][:128]
        assert (n0, n1) == (a, b) and np.array_equal(m[:, 0], src[::2])


# --- the kernels, on the card ----------------------------------------------


def _both(dev, xy1, xy2, valid, h, seed):
    """(samples, the kernel's result, the plain version's) on the same
    samples, both on the card; the kernel's result checked against its own
    rules."""
    xy1, xy2, valid = xy1.to(dev), xy2.to(dev), valid.to(dev)
    idx = twoview.sample_eight(valid, h, torch.Generator(dev).manual_seed(seed))
    before = cuda_twoview.ransac.launches
    got = twoview.verify_fundamental_ransac_core(xy1, xy2, valid, idx, THR)
    assert cuda_twoview.ransac.launches == before + 1
    ref = twoview.verify_fundamental_ransac_plain(xy1, xy2, valid, idx, THR)
    torch.cuda.synchronize()
    num = got.inliers.sum(-1)
    ratio = num.float() / valid.sum(-1).clamp(min=1).float()
    assert bool((got.inliers <= valid).all())
    assert torch.equal(got.num_inliers, num.int())
    assert torch.equal(got.success, (num >= 15) & (ratio >= 0.1))
    assert torch.equal(got.success, ref.success), (got.success, ref.success)
    return idx, got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_scores_as_accurately_as_the_plain_version(cuda_device, seed):
    """Every hypothesis' MSAC on the same samples, by
    ``twoview_parity.score_failures``: within a quarter of the plain
    version's own float32 gap to float64 from the plain version's, as near
    float64 as the plain version, at least a quarter within 1e-4."""
    xy1, xy2, valid, _ = (t.to(cuda_device) for t in pairs(np.random.default_rng(seed), 8, 1024))
    idx = twoview.sample_eight(valid, 1024, torch.Generator(cuda_device).manual_seed(seed))
    g = twoview_parity.hypothesis_gaps(xy1, xy2, valid, idx)
    assert twoview_parity.score_failures(g) == [], twoview_parity.summary(g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed0", "seed1", "random_mask"])
def test_kernel_local_optimisation_as_the_plain_version(cuda_device, case):
    """``twoview_refine`` alone from an eight-point start of planted inliers,
    128 pairs in normalised coordinates: the 4 steps improve at least 90 %
    of the pairs, and the MSAC after them sits as near the plain version's
    float64 run as the plain version's float32 run, within a factor of 3."""
    seed, kw = {"seed0": (0, {}), "seed1": (1, {}), "random_mask": (2, dict(mask=0.85))}[case]
    case = twoview_parity.lo_case(np.random.default_rng(30 + seed), 128, 1024, cuda_device, **kw)
    g = twoview_parity.lo_gaps(*case)
    assert twoview_parity.lo_failures(g) == [], (twoview_parity.summary(g), g["taken"])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_verifies_as_the_plain_version(cuda_device, seed):
    """48 pairs of the map build's shape, 8 of them all outliers, on the same
    samples: the same success on every pair, the inlier decisions as close
    to the ground truth as the plain version's, and most masks equal. Which
    hypothesis wins a pair is a draw of rounding for both versions (one
    pair's share of correct decisions can move by 0.2 between them); on an
    H100 the mean over 16 pairs moved by -0.011 to +0.02 in five draws, so
    the mean over 40 is held within 0.02."""
    xy1, xy2, valid, truth = pairs(np.random.default_rng(seed), 48, 1024, all_out=8)
    _, got, ref = _both(cuda_device, xy1, xy2, valid, 2048, seed)
    assert got.success.tolist() == [True] * 40 + [False] * 8
    truth = truth.to(cuda_device)
    near = lambda r: float((r.inliers == truth)[:40].float().mean())  # noqa: E731
    assert near(got) >= near(ref) - 0.02, (near(got), near(ref))
    assert float((got.inliers == ref.inliers)[:40].float().mean()) >= 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_pair", "partial_batch", "n1000", "n2500", "random_mask",
                                  "ragged_prefix", "n5000", "n9000_mask"])
def test_kernel_edge_shapes(cuda_device, case):
    """The shapes and masks the kernels tile and list: the same success as the
    plain version on the same samples and hypotheses scored as it scores
    them (a sample or tile read from the wrong place would move every
    MSAC), by ``twoview_parity.score_failures`` without the 90th percentile
    of the gap from the plain version, which 1 to 7 pairs are too few to
    hold."""
    b, n, kw = {"one_pair": (1, 1024, {}), "partial_batch": (7, 1024, {}),
                "n1000": (5, 1000, {}), "n2500": (3, 2500, {}),
                "random_mask": (6, 1024, dict(mask=0.85)),
                "ragged_prefix": (6, 640, dict(n_valid=np.array([640, 500, 77, 12, 200, 9]))),
                "n5000": (3, 5000, {}), "n9000_mask": (3, 9000, dict(mask=0.7))}[case]
    xy1, xy2, valid, _ = pairs(np.random.default_rng(11), b, n, **kw)
    idx, got, _ = _both(cuda_device, xy1, xy2, valid, 256, 7)
    if case == "ragged_prefix":
        assert got.success.tolist() == [True, True, True, False, True, False]
    g = twoview_parity.hypothesis_gaps(*(t.to(cuda_device) for t in (xy1, xy2, valid)), idx)
    assert twoview_parity.score_failures(g, tail=False) == [], twoview_parity.summary(g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uint8_mask", "float64", "n9000"])
def test_the_route_on_the_card(cuda_device, case):
    """On the card float32 takes the kernels at any N and with any mask
    dtype (taken as bool); float64 takes the plain version."""
    n = 9000 if case == "n9000" else 512
    xy1, xy2, valid, _ = (t.to(cuda_device) for t in pairs(np.random.default_rng(16), 2, n))
    if case == "uint8_mask":
        valid = valid.to(torch.uint8)
    if case == "float64":
        xy1, xy2 = xy1.double(), xy2.double()
    before, launches = _counts(), cuda_twoview.ransac.launches
    got = twoview.verify_fundamental_ransac(xy1, xy2, valid, THR,
                                            torch.Generator(cuda_device).manual_seed(0),
                                            num_hypotheses=256)
    kernel = case != "float64"
    assert cuda_twoview.ransac.launches == launches + kernel
    after = _counts()
    assert after["kernel_batches"] - before["kernel_batches"] == kernel
    assert after["plain_batches"] - before["plain_batches"] == (not kernel)
    assert got.success.tolist() == [True, True] and got.inliers.dtype == torch.bool


@pytest.mark.cuda
def test_kernel_fails_a_pair_with_fewer_than_eight_valid_matches(cuda_device):
    xy1, xy2, valid, _ = (t.to(cuda_device) for t in
                          pairs(np.random.default_rng(12), 3, 256, n_valid=np.array([256, 7, 0])))
    got = twoview.verify_fundamental_ransac(xy1, xy2, valid, THR,
                                            torch.Generator(cuda_device).manual_seed(0),
                                            num_hypotheses=256)
    torch.cuda.synchronize()
    assert got.success.tolist() == [True, False, False]
    assert got.num_inliers[1:].tolist() == [0, 0] and not bool(got.inliers[1:].any())


def _philox(ctr, key):
    """Philox4x32-10 on numpy uint64 arrays holding 32-bit words: ctr
    [4, m], key [2] → [4, m]."""
    m32 = np.uint64(0xFFFFFFFF)
    c0, c1, c2, c3 = (c.astype(np.uint64) for c in ctr)
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for _ in range(10):
        p0, p1 = np.uint64(0xD2511F53) * c0, np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m32,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & m32)
        k0, k1 = (k0 + np.uint64(0x9E3779B9)) & m32, (k1 + np.uint64(0xBB67AE85)) & m32
    return np.stack([c0, c1, c2, c3])


def _model_draw(key, b, h, nv):
    """The kernel's draw (csrc/twoview.cu::draw_eight) in numpy: [h, 8]
    indices into the valid list."""
    k = int(key[0]) & (2**64 - 1)
    kw = int(key[1]) & 0xFFFFFFFF
    out = np.zeros((h, 8), np.int64)
    for hyp in range(h):
        got, blk = [], 0
        while len(got) < 8:
            words = _philox(np.array([[hyp], [b], [blk], [kw]], np.uint64),
                            (k & 0xFFFFFFFF, k >> 32))[:, 0]
            for w in words:
                c = (int(w) * nv) >> 32
                if len(got) < 8 and c not in got:
                    got.append(c)
            blk += 1
        out[hyp] = got
    return out


@pytest.mark.cuda
def test_in_kernel_sampler_draws_eight_distinct_valid_uniform_positions(cuda_device):
    rng = np.random.default_rng(13)
    b, n, h = 3, 64, 8192
    xy1, xy2, valid, _ = (t.to(cuda_device) for t in pairs(rng, b, n, mask=0.6))
    key = cuda_twoview.draw_key(torch.Generator(cuda_device).manual_seed(5), cuda_device)
    idx = torch.empty((b, h, 8), dtype=torch.int32, device=cuda_device)
    cuda_twoview.ransac(xy1, xy2, valid, THR, 15, 0.1, key=key, num_hypotheses=h, idx_out=idx)
    idx, valid, key = idx.cpu().numpy(), valid.cpu().numpy(), key.cpu().numpy()
    for i in range(b):
        lst = np.nonzero(valid[i])[0]
        got = idx[i]
        assert all(len(set(row)) == 8 for row in got[:512].tolist())
        assert (np.sort(got, 1)[:, 1:] != np.sort(got, 1)[:, :-1]).all()
        assert valid[i][got].all()
        np.testing.assert_array_equal(got[:48], lst[_model_draw(key, i, 48, len(lst))])
        counts = np.bincount(np.searchsorted(lst, got.ravel()), minlength=len(lst))
        expect = h * 8 / len(lst)
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        df = len(lst) - 1
        assert (chi2 - df) / math.sqrt(2 * df) < 5.0, (chi2, df)


@pytest.mark.cuda
def test_the_same_generator_seed_gives_the_same_bits(cuda_device):
    xy1, xy2, valid, _ = (t.to(cuda_device) for t in pairs(np.random.default_rng(14), 6, 1024,
                                                           mask=0.85))

    def run(seed):
        res = twoview.verify_fundamental_ransac(xy1, xy2, valid, THR,
                                                torch.Generator(cuda_device).manual_seed(seed))
        return [t.cpu() for t in res]

    a, b, c = run(3), run(3), run(4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert bool(a[3].all())


@pytest.mark.cuda
def test_geometric_verification_on_the_card_takes_the_kernel(cuda_device):
    feats, matches, pair_list = _store_scene(np.random.default_rng(15))
    cfg = TriangulationConfig(verify_batch=4)
    before = _counts()
    got = geometric_verification(feats, matches, pair_list, cfg, max_matches=256,
                                 device=cuda_device)
    after = _counts()
    assert after["kernel_batches"] - before["kernel_batches"] == 2
    assert after["plain_batches"] == before["plain_batches"]
    assert after["hypotheses"] - before["hypotheses"] == len(pair_list) * 2048
    assert [p[:2] for p in got] == pair_list
    for _, _, m in got:  # the true matches kept, the wrong ones dropped
        assert (m[:, 0] == m[:, 1]).mean() > 0.97 and len(m) > 150
