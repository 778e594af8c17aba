"""The port's one-line harness (``sfd2_torch/scripts/bench.py``) against
``bench.py`` and the JAX package, on the CPU at the quick shapes.

- ``_compose`` on the same ``shared`` dicts as ``bench._compose``: every
  key both lines hold is equal, except ``extract_membw_frac``, whose peak
  is the H100's 3.35 TB/s (and only on the card); the TPU-file
  comparisons (``vs_*``) are absent from the port's line.
- Each stage program on the port's numpy stage inputs against the JAX
  function on the same inputs: extraction through ``ResSegNetV2`` with the
  JAX variables carried across (f32, ≥ 98 % identical keypoints,
  descriptors within 1e-4), mutual NN (identical indices, scores within
  1e-5), the 5 × LM(2) refinement (pose within 1e-5), the BA stage's
  final cost in float64 (1e-4 relative), triangulation (errors within
  1e-5), PnP-RANSAC and F-RANSAC through their cores fed the JAX
  sampler's indices (pose within 1e-5, identical inlier counts; F-RANSAC
  in float64, where ``tests/test_torch_sfm.py`` holds it).
- The hand count of the extraction's FLOPs against the count from the
  Flax parameter shapes.
- A whole quick run in-process on the CPU (its windows timed by one call
  each), a stage that raises, and ``--device cuda`` without a card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from sfd2_torch.localization.ransac import pnp_ransac_core
from sfd2_torch.models.convert import state_dict_from_flax
from sfd2_torch.pipeline.extract import _RGB_MEAN, _RGB_STD
from sfd2_torch.scripts import bench as tb
from sfd2_torch.sfm.ba import bundle_adjust
from sfd2_torch.sfm.twoview import verify_fundamental_ransac_core
from sfd2_tpu.localization.pnp import refine_pose_lm as jrefine_pose_lm
from sfd2_tpu.localization.ransac import pnp_ransac as jpnp_ransac
from sfd2_tpu.models.sfd2 import ResSegNetV2 as JResSegNetV2
from sfd2_tpu.ops.extract import extract_keypoints as jextract_keypoints
from sfd2_tpu.ops.matching import mutual_nn_match as jmutual_nn_match
from sfd2_tpu.sfm import ba as jba
from sfd2_tpu.sfm.triangulation import triangulate_tracks as jtriangulate_tracks
from sfd2_tpu.sfm.twoview import verify_fundamental_ransac as jverify

torch.set_num_threads(2)

SHAPES = tb.SMALL
TPU_ONLY = {"vs_baseline", "vs_baseline_ref", "prev_round_fps", "vs_r01", "r01_note",
            "relay_rtt_ms"}


@pytest.fixture(scope="module")
def inputs():
    return tb.stage_inputs(SHAPES)


# ---------------------------------------------------------------------------
# (a) _compose against bench._compose
# ---------------------------------------------------------------------------

TIMES = {"extract": 6e-3, "match": 30e-6, "pnp": 1.3e-3, "refine": 0.25e-3, "ba": 50e-3}
CASES = {
    "empty": {},
    "partial": {"times": {"match": 30e-6, "gemm": 1.0}, "n_db": 50, "gemm_flops_total": 1e12,
                "platform": "tpu"},
    "complete": {"times": dict(TIMES), "n_db": 50, "ba_frames": 50, "passes_completed": 3},
    "quick": {"quick": True, "times": {"match": 1e-5}, "n_db": 50},
    "fatal": {"times": {"match": 1e-5}, "n_db": 50,
              "stage_errors": {"fatal": "RuntimeError: out of memory"}},
    "times_by_pass": {"times": dict(TIMES), "n_db": 50, "ba_frames": 50,
                      "times_by_pass": [dict(TIMES), {k: v * 1.1 for k, v in TIMES.items()},
                                        {"extract": 5e-3}]},
    "extras": {"times": dict(TIMES, extract1600=11e-3, verify=2e-3, triang=3e-7), "n_db": 50,
               "ba_frames": 50, "matcher": "cuda", "fused_stem": "cuda", "kernels_exact": True,
               "kernel_deltas": {"nnm_idx": 0}, "e2e_query_ms": 130.0,
               "e2e_recall_025m_2deg": 1.0, "e2e_note": "n"},
    "card_roofline": {"times": dict(TIMES, gemm=2e-3), "n_db": 50, "ba_frames": 50,
                      "platform": "cuda", "gemm_flops_total": 8 * 2 * 4096 ** 3,
                      "extract_flops": 16 * 453.9e9, "extract_bytes": 16 * 1.24e9,
                      "ex_batch": 16, "rtt": 2e-5, "fence": 2e-5, "matcher": "cuda"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compose_matches_bench(case):
    ref = bench._compose(dict(json.loads(json.dumps(CASES[case])), ledger=(None, None, None)))
    got = tb._compose(json.loads(json.dumps(CASES[case])))
    json.dumps(got)
    assert not TPU_ONLY & set(got)
    assert set(ref) - TPU_ONLY - {"extract_membw_frac"} <= set(got)
    for key in set(ref) & set(got) - {"extract_membw_frac"}:
        assert got[key] == ref[key], key
    shared = CASES[case]
    if shared.get("platform") == "cuda":
        gbs = shared["extract_bytes"] / 16 / TIMES["extract"]
        assert got["extract_membw_frac"] == round(gbs / 3.35e12, 3)
        assert got["mfu_vs_peak"] == round(shared["extract_flops"] / 16 / TIMES["extract"]
                                           / 989e12, 3)
        assert got["fence_ms"] == round(shared["fence"] * 1e3, 4)
    else:
        assert "extract_membw_frac" not in got and "mfu_vs_peak" not in got


def test_failed_lines():
    assert not tb.failed({"value": 1.0, "kernels_exact": None})
    for bad in ({"partial": True}, {"error": "x"}, {"stage_errors": {"ba": "x"}},
                {"kernels_exact": False}):
        assert tb.failed(bad)


# ---------------------------------------------------------------------------
# (b) the stage programs against the JAX functions
# ---------------------------------------------------------------------------


def test_extract_stage_matches_jax(inputs):
    model = JResSegNetV2(require_stability=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    ex = tb.make_extractor(state_dict_from_flax(variables), SHAPES.k, "cpu")
    got = tb.extract_stage(ex, inputs["images"], "extract", 8).fn().numpy()
    x = (inputs["images"].astype(np.float32) / 255.0 - _RGB_MEAN) / _RGB_STD

    @jax.jit
    def extract(variables, x):  # bench.py:396-402
        out = model.apply(variables, x)
        return jextract_keypoints(out.score, out.descriptors, out.stability,
                                  max_keypoints=SHAPES.k, conf_threshold=0.001)

    ref = extract(variables, jnp.asarray(x))
    for i in range(SHAPES.ex_batch):
        kt = {tuple(p): j for j, p in enumerate(got[i, :, :2].astype(int)) if got[i, j, -1] > 0}
        kj = {tuple(p): j for j, p in enumerate(np.asarray(ref.xy[i]).astype(int))
              if bool(ref.valid[i, j])}
        common = sorted(set(kt) & set(kj))
        assert len(kj) > 0.5 * SHAPES.k and len(common) >= 0.98 * len(kj), (len(common), len(kj))
        it, ij = [kt[p] for p in common], [kj[p] for p in common]
        np.testing.assert_allclose(got[i, it, 3:3 + tb.C], np.asarray(ref.descriptors[i])[ij],
                                   atol=1e-4)


def test_match_stage_matches_jax(inputs):
    m_t, s_t = tb.match_stage(inputs, "cpu").fn()
    m_j, s_j = jax.vmap(lambda a, b: jmutual_nn_match(a, b, None, None))(
        jnp.asarray(inputs["match_q"]), jnp.asarray(inputs["match_db"]))
    assert m_t.shape == (SHAPES.match_chunk, SHAPES.k)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


def _jax_indices(valid, h, key, size):
    """The minimal sets JAX's samplers draw from `key` (Gumbel top-`size`)."""
    fvalid = jnp.asarray(valid, jnp.float32)

    def one(k):
        return jax.lax.top_k(jax.random.gumbel(k, (len(valid),)) + jnp.log(fvalid + 1e-30),
                             size)[1]

    return np.asarray(jax.vmap(one)(jax.random.split(key, h)))


@pytest.fixture(scope="module")
def jax_pnp(inputs):
    key = jax.random.PRNGKey(1)
    pnp = jax.jit(lambda xy, p3, cam, v, k: jpnp_ransac(xy, p3, cam, v, threshold=15.0, key=k,
                                                        num_hypotheses=tb.N_HYP))
    res = pnp(*(jnp.asarray(inputs[k]) for k in ("pnp_xy", "pnp_pts", "cam8", "pnp_valid")),
              key)
    return res, _jax_indices(inputs["pnp_valid"], tb.N_HYP, key, 6)


def _close_pose(q_t, t_t, q_j, t_j, atol=1e-5):
    q_t, q_j = np.asarray(q_t, np.float64), np.asarray(q_j, np.float64)
    np.testing.assert_allclose(q_t * np.sign(q_t @ q_j), q_j, atol=atol)
    np.testing.assert_allclose(t_t, t_j, atol=atol)


def test_pnp_core_matches_jax(inputs, jax_pnp):
    ref, idx = jax_pnp
    got = pnp_ransac_core(*(torch.from_numpy(inputs[k]) for k in ("pnp_xy", "pnp_pts", "cam8",
                                                                  "pnp_valid")),
                          torch.from_numpy(idx), threshold=15.0)
    assert int(got.num_inliers) == int(ref.num_inliers) > 0.9 * tb.N_CORR
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    _close_pose(got.qvec.numpy(), got.tvec.numpy(), ref.qvec, ref.tvec)
    # The stage itself: the engine's sampler, the same scene.
    res = tb.pnp_stage(inputs, "cpu").fn()
    assert bool(res.success) and int(res.num_inliers) > 0.9 * tb.N_CORR


def test_refine_stage_matches_jax(inputs, jax_pnp):
    ref, _ = jax_pnp

    @jax.jit
    def refine(q, t, p3, xy, cam, w):  # bench.py:472-476
        for _ in range(5):
            q, t = jrefine_pose_lm(q, t, p3, xy, cam, w, iterations=2)
        return q, t

    q, t = refine(ref.qvec, ref.tvec, *(jnp.asarray(inputs[k]) for k in ("pnp_pts", "pnp_xy",
                                                                       "cam8")),
                  ref.inliers.astype(jnp.float32))
    stage = tb.refine_stage(inputs, "cpu", torch.from_numpy(np.asarray(ref.qvec)),
                            torch.from_numpy(np.asarray(ref.tvec)),
                            torch.from_numpy(np.asarray(ref.inliers)))
    out = stage.fn().numpy()[0]
    _close_pose(out[:4], out[4:7], q, t)


def test_ba_stage_matches_bundle_adjust_and_jax(inputs):
    """The stage's LM iteration is ``bundle_adjust``'s (the same bits); its
    costs within 1e-4 relative of the JAX package's on the same problem.
    Both in float32: the JAX solver's scan carries λ as float32, so it
    does not run in float64."""
    got = tb.ba_stage(inputs, "cpu").fn()
    ref = bundle_adjust(tb.ba_problem(inputs, "cpu"), lm_iters=3, cg_iters=10)
    assert torch.equal(got.points, ref.points) and float(got.final_cost) == float(ref.final_cost)
    assert float(got.final_cost) < 0.5 * float(got.initial_cost)
    jref = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in inputs["ba"].items()}),
                             lm_iters=3, cg_iters=10)
    np.testing.assert_allclose(float(got.initial_cost), float(jref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(jref.final_cost), rtol=1e-4)


def test_triang_stage_matches_jax(inputs):
    """Points within 1e-5 relative, the same verdicts; the mean
    reprojection errors within 1e-4 px (float32 resolves pixel
    coordinates near 1,000 px to 6e-5–1.2e-4)."""
    got = tb.triang_stage(inputs, "cpu").fn()
    ref = jtriangulate_tracks(**{k: jnp.asarray(v) for k, v in inputs["triang"].items()})
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))
    assert valid.mean() > 0.9
    want = np.asarray(ref.xyz)[valid]
    gap = np.linalg.norm(got.xyz.numpy()[valid] - want, axis=1) / np.linalg.norm(want, axis=1)
    assert gap.max() <= 1e-5, gap.max()
    np.testing.assert_allclose(got.errors.numpy()[valid], np.asarray(ref.errors)[valid],
                               atol=1e-4)


def test_verify_core_matches_jax_float64(inputs):
    """Each pair fed the indices JAX's F-RANSAC draws from its key, both
    packages in float64: identical inlier counts and masks."""
    xy1, xy2, val = (inputs[k] for k in ("verify_xy1", "verify_xy2", "verify_valid"))
    h = SHAPES.verify_hyp
    keys = [jax.random.PRNGKey(i) for i in range(len(xy1))]
    with jax.enable_x64(True):  # the samplers draw float64 Gumbel noise here
        idx = [_jax_indices(val[i], h, key, 8) for i, key in enumerate(keys)]
        verify = jax.jit(jax.vmap(lambda a, b, v, k: jverify(a, b, v, 4.0, k, num_hypotheses=h)))
        r = verify(jnp.asarray(xy1, jnp.float64), jnp.asarray(xy2, jnp.float64),
                   jnp.asarray(val), jnp.stack(keys))
        counts, masks = np.asarray(r.num_inliers).tolist(), np.asarray(r.inliers)
    got = verify_fundamental_ransac_core(
        torch.from_numpy(xy1).double(), torch.from_numpy(xy2).double(), torch.from_numpy(val),
        torch.from_numpy(np.stack(idx)).long())
    assert got.num_inliers.tolist() == counts
    np.testing.assert_array_equal(got.inliers.numpy(), masks)
    assert got.success.all()
    res = tb.verify_stage(inputs, "cpu", h).fn()  # the stage: float32, its own sampler
    assert res.success.all()


# ---------------------------------------------------------------------------
# (c) the hand count of the extraction's FLOPs
# ---------------------------------------------------------------------------

# Each Flax convolution's output stride: the stem's conv1b, conv2b and
# convPa's first conv halve the resolution.
STRIDE = {"conv1a": 1, "conv1b": 2, "conv2a": 2, "conv2b": 4, "conv3a": 4, "conv3b": 4,
          "convDa": 4, "convDb": 4, "convSta": 4, "res1": 4, "res2": 4, "res3": 4,
          "convPa": 8, "convPb": 8}


def test_extract_flops_equal_the_flax_parameter_count():
    hw = 256
    model = JResSegNetV2(require_stability=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = 0
    for path, a in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        if path[-1].key == "kernel":
            s = STRIDE[path[0].key]
            want += 2 * int(np.prod(a.shape)) * (hw // s) ** 2
    ex = tb.make_extractor(state_dict_from_flax(variables), 512, "cpu")
    flops, nbytes = tb.extract_cost(ex.model, 2, hw, hw)
    assert flops == 2 * want
    assert nbytes > 2 * hw * hw * 3 * 4
    x = jnp.zeros((1, hw, hw, 3))
    cost = jax.jit(lambda v, x: model.apply(v, x)).lower(variables, x).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    print(f"hand count {want / 1e9:.3f} GFLOP/img, XLA cost_analysis "
          f"{float(cost.get('flops', 0.0)) / 1e9:.3f} GFLOP/img (for information)")


# ---------------------------------------------------------------------------
# (d)-(f) the whole run
# ---------------------------------------------------------------------------


def _one_window(fn, fence=None, items_per_call=1, iters=3, inner=8, rtt=0.0, **_):
    """A timed window of one call: the run's plumbing, not its numbers."""
    import time

    t0 = time.perf_counter()
    out = fn()
    if fence is not None:
        fence(out)
    return max(time.perf_counter() - t0, 1e-9) / items_per_call


def _run(capsys, argv):
    code = tb.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return code, json.loads(lines[0])


def test_quick_cpu_run_in_process(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tb, "timed_per_item", _one_window)
    for var in ("BENCH_E2E", "BENCH_EXACT", "BENCH_QUICK", "BENCH_PASSES"):
        monkeypatch.delenv(var, raising=False)
    code, line = _run(capsys, ["--quick", "--device", "cpu", "--passes", "1"])
    assert code == 0
    for key in ("extract_ms", "match50_ms", "pnp_ms", "refine_ms", "ba_ms", "verify_pair_ms",
                "triang_pt_us", "fps_median_passes", "fence_ms", "mfu"):
        assert line[key] > 0, key
    assert line["platform"] == "cpu" and line["quick"] and line["passes_completed"] == 1
    assert not {"partial", "error", "stage_errors", "extract1600_ms"} & set(line)
    assert line["kernels_exact"] is None and line["kernel_deltas"] == "plain"
    assert line["matcher"] == "plain" and line["fused_stem"] == "off"
    assert "extract_membw_frac" not in line and "mfu_vs_peak" not in line
    assert line["e2e_recall_025m_2deg"] == 1.0 and line["e2e_recall_batched"] == 1.0
    assert line["graph_captures_in_passes"] == 0
    attempts = (tmp_path / "chiprun_out" / "BENCH_ATTEMPTS_torch.jsonl").read_text().splitlines()
    assert [json.loads(a)["event"] for a in attempts] == ["start", "end"]
    assert json.loads((tmp_path / "chiprun_out" / "BENCH_torch.json").read_text()) == line


def test_a_stage_that_raises_fails_the_run(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tb, "timed_per_item", _one_window)
    monkeypatch.setenv("BENCH_E2E", "0")
    monkeypatch.setenv("BENCH_EXACT", "0")
    monkeypatch.setattr(tb, "SMALL", tb.SMALL._replace(hw=64, k=64, ba_points=128,
                                                       ba_obs_per_cam=16, triang_tracks=32))
    monkeypatch.setattr(tb, "N_HYP", 64)
    real = tb.triang_stage

    def raising(inp, dev):
        stage = real(inp, dev)
        calls = []

        def fn():
            calls.append(1)
            if len(calls) > 1:  # the warm call passes, the measurement raises
                raise RuntimeError("triangulation failed")
            return stage.fn()

        return stage._replace(fn=fn)

    monkeypatch.setattr(tb, "triang_stage", raising)
    code, line = _run(capsys, ["--quick", "--device", "cpu", "--passes", "1", "--out",
                               str(tmp_path / "line.json")])
    assert code == 1
    assert line["stage_errors"] == {"triang": "RuntimeError: triangulation failed"}
    assert "triang_pt_us" not in line and line["pnp_ms"] > 0
    assert os.path.exists(tmp_path / "line.json")


def test_device_cuda_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.main(["--device", "cuda"])
    assert capsys.readouterr().out == ""
