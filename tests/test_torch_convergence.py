"""The port's training loop learns: the recipe and bars of
``tests/test_convergence.py``, run through ``sfd2_torch``.

200 optimisation steps on one synthetic shifted pair (48², lr 3e-4, the
small sampler) from the JAX package's initialisation (``PRNGKey(0)``
student, ``PRNGKey(1)`` SuperPoint, carried across) must cut the mean loss
of the last 10 steps below 0.92 × the first 10's and raise the student
heatmap's correlation with the frozen teacher's by more than 0.06. The
sampler's positions come from a seeded ``torch.Generator`` per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sfd2_torch.models.convert import state_dict_from_flax
from sfd2_torch.models.convert_baselines import superpoint_from_flax
from sfd2_torch.models.sfd2 import ResSegNetV2 as TResSegNetV2
from sfd2_torch.models.superpoint import SuperPoint as TSuperPoint
from sfd2_torch.training import train_step as t_step
from sfd2_torch.training.losses import SegLossConfig
from sfd2_torch.training.sampler import NghSampler2DS
from sfd2_tpu.models.sfd2 import ResSegNetV2
from sfd2_tpu.models.superpoint import SuperPoint
from test_convergence import _shifted_pair_batch

torch.set_num_threads(2)


def test_training_converges_and_tracks_teacher():
    r = 48
    jbatch, img1 = _shifted_pair_batch(np.random.default_rng(3), r=r)
    batch = t_step.TrainBatch(*[torch.from_numpy(np.array(a)) for a in jbatch[:6]])
    jmodel = ResSegNetV2(require_stability=True, require_feature=True)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    sp_vars = jax.jit(SuperPoint().init)(jax.random.PRNGKey(1), jnp.zeros((1, r, r, 1)))
    model = TResSegNetV2(require_stability=True, require_feature=True)
    model.load_state_dict(state_dict_from_flax(variables))
    sp = TSuperPoint()
    sp.load_state_dict(superpoint_from_flax(sp_vars))
    cfg = t_step.TrainConfig(lr=3e-4, loss=SegLossConfig(topk_per_half=32),
                             sampler=NghSampler2DS(ngh=3, subq=-4, pos_d=1, neg_d=2, border=3,
                                                   subd_neg=-4))
    state = t_step.TrainState(model=model, optimizer=t_step.make_optimizer(cfg, model))
    step = t_step.make_train_step(model, sp, cfg)
    with torch.no_grad():
        gt = sp(batch.gray1)["scores"][0].numpy()

    def det_corr():
        model.eval()
        with torch.no_grad():
            score = model(torch.from_numpy(img1[None])).score[0].numpy()
        return float(np.corrcoef(score.ravel(), gt.ravel())[0, 1])

    corr_init = det_corr()
    losses = []
    for i in range(200):
        gen = torch.Generator().manual_seed(i)
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert state.step == 200
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first * 0.92, (first, last)
    corr_after = det_corr()
    assert corr_after > corr_init + 0.06, (corr_init, corr_after)
