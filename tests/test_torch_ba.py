"""Bundle adjustment of the port against the JAX package.

The problems are those of ``tests/test_ba.py`` (6 cameras, 120 points,
cameras 0 and 1 fixed as gauge anchors). Both packages run the same
Schur-PCG Levenberg–Marquardt in float32 with sums taken in another
order, so the final cost is held to 1e-3 relative and the poses to 1e-4:
both runs converge to the same minimum, where rounding no longer moves
the estimate at that level. The LM iteration that ``bundle_adjust``
replays from a CUDA graph on the card is ``lm_setup``'s function; stepped
by hand on CPU tensors it gives exactly what ``bundle_adjust`` gives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.ops.cuda_gather import gather_rows_cuda
from sfd2_torch.sfm import ba as tba
from sfd2_tpu.sfm import ba as jba
from test_ba import build_problem

torch.set_num_threads(2)


def _port_problem(problem):
    return tba.BAProblem(*(torch.from_numpy(np.array(a)) for a in problem))


def _compare(ref, got, cost_rtol=1e-3, pose_atol=1e-4):
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost), rtol=cost_rtol)
    q_t, q_j = got.qvecs.numpy(), np.asarray(ref.qvecs)
    sign = np.sign(np.sum(q_t * q_j, axis=1, keepdims=True))
    np.testing.assert_allclose(q_t * sign, q_j, atol=pose_atol)
    np.testing.assert_allclose(got.tvecs.numpy(), np.asarray(ref.tvecs), atol=pose_atol)


@pytest.mark.parametrize("lm_iters,cg_iters", [(10, 15), (3, 5)])
def test_bundle_adjust_matches_jax(lm_iters, cg_iters):
    problem, _ = build_problem(np.random.default_rng(0))
    ref = jba.bundle_adjust(problem, lm_iters=lm_iters, cg_iters=cg_iters)
    before = gather_rows_cuda.launches
    got = tba.bundle_adjust(_port_problem(problem), lm_iters=lm_iters, cg_iters=cg_iters)
    assert gather_rows_cuda.launches == before  # CPU tensors: K3's plain version
    assert float(got.final_cost) < float(got.initial_cost) * 0.2
    _compare(ref, got)
    np.testing.assert_allclose(got.tvecs[:2].numpy(), np.asarray(problem.tvecs)[:2], atol=1e-6)


def test_bundle_adjust_with_outliers_matches_jax():
    problem, _ = build_problem(np.random.default_rng(0), n_outliers=60)
    ref = jba.bundle_adjust(problem, lm_iters=10, cg_iters=15, huber_delta=2.0)
    got = tba.bundle_adjust(_port_problem(problem), lm_iters=10, cg_iters=15, huber_delta=2.0)
    _compare(ref, got)


def test_point_only_bundle_adjust_matches_jax():
    problem, _ = build_problem(np.random.default_rng(0), perturb=False)
    problem = problem._replace(points=problem.points + 0.1,
                               fixed_cams=jnp.ones(problem.qvecs.shape[0], bool))
    ref = jba.bundle_adjust(problem, lm_iters=15, cg_iters=5)
    got = tba.bundle_adjust(_port_problem(problem), lm_iters=15, cg_iters=5)
    _compare(ref, got)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-4)


@pytest.mark.parametrize("lm_iters,cg_iters,n_outliers,huber_delta",
                         [(10, 15, 0, 4.0), (3, 5, 0, 4.0), (6, 15, 60, 2.0)])
def test_lm_iteration_stepped_by_hand_equals_bundle_adjust(lm_iters, cg_iters, n_outliers,
                                                           huber_delta):
    problem, _ = build_problem(np.random.default_rng(0), n_outliers=n_outliers)
    ref = jba.bundle_adjust(problem, lm_iters=lm_iters, cg_iters=cg_iters,
                            huber_delta=huber_delta)
    port = _port_problem(problem)
    got = tba.bundle_adjust(port, lm_iters=lm_iters, cg_iters=cg_iters, huber_delta=huber_delta)
    iterate, state = tba.lm_setup(port, cg_iters=cg_iters, huber_delta=huber_delta)
    assert isinstance(state, tba.LMState)
    for _ in range(lm_iters):
        state = iterate(state)
    hand = tba.lm_result(state)
    for a, b in zip(hand, got):
        assert torch.equal(a, b)
    _compare(ref, hand)
    _compare(ref, got)


def test_card_test_problem_is_the_jax_test_problem():
    """The card tests build their BA problem with numpy alone
    (``test_torch_kernels.py::_ba_problem``): it is this file's problem."""
    from test_torch_kernels import _ba_problem

    ref, _ = build_problem(np.random.default_rng(0))
    got = _ba_problem("cpu", np.random.default_rng(0))
    for name, a, b in zip(ref._fields, ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, err_msg=name)


def test_small_block_inverses_match_jax(rng):
    a = rng.normal(size=(7, 6, 6)).astype(np.float32)
    spd = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(tba._inv6_spd_lanes(torch.from_numpy(spd)).numpy(),
                               np.asarray(jba._inv6_spd_lanes(jnp.asarray(spd))),
                               rtol=1e-3, atol=1e-4)
    m3 = spd[:, :3, :3]
    np.testing.assert_allclose(tba._inv3_lanes(torch.from_numpy(m3)).numpy(),
                               np.asarray(jba._inv3_lanes(jnp.asarray(m3))), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_seg,n_rows,layout", [
    (6, 720, "uniform"),  # the test problem's cameras
    (120, 720, "uniform"),  # its points
    (60, 65377, "skewed"),  # map BA's cameras: degrees into the thousands, three levels
    (5, 0, "uniform"),  # no observations
    (9, 40, "gaps"),  # segments without rows
])
def test_segment_plan_equals_a_float64_index_add(n_seg, n_rows, layout):
    """BA's per-camera and per-point sums (``SegmentPlan``: a fixed order,
    no atomics) within 1e-6 of the largest float64 ``index_add_`` sum."""
    rng = np.random.default_rng(n_seg + n_rows)
    if layout == "skewed":
        seg = np.minimum(rng.geometric(0.05, n_rows) - 1, n_seg - 1)
    elif layout == "gaps":
        seg = rng.choice(np.arange(0, n_seg, 3), n_rows)
    else:
        seg = rng.integers(0, n_seg, n_rows)
    seg = torch.from_numpy(seg).to(torch.int32)
    plan = tba.SegmentPlan(seg, n_seg)
    for shape in ((6, 6), (3,)):
        vals = torch.from_numpy(rng.normal(size=(n_rows, *shape)).astype(np.float32))
        got = plan(vals)
        ref = torch.zeros((n_seg, *shape), dtype=torch.float64).index_add_(
            0, seg.long(), vals.double())
        assert got.shape == ref.shape and got.dtype == torch.float32
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got.double() - ref).abs().max()) <= 1e-6 * scale
        assert torch.equal(plan(vals), got)  # one order, one answer
    if layout == "skewed":
        assert len(plan.levels) == 3
