"""The port's confusion matrix, Evaluator, eval step and validation report
against the JAX package's (s2r_tpu/eval/metrics.py, train/steps.py
make_eval_step, cli/_eval_common.py validation), on the CPU.

- confusion_matrix and the four Evaluator metrics: exact on random labels
  with 255s.
- The port accumulates in int64: a merge that takes one cell past 2^24
  stays exact (the JAX package's float32 accumulation rounds it, ROADMAP
  C.8).
- make_eval_step at 65x65 on one set of weights (the JAX init with
  perturbed statistics): loss rtol 1e-5; the confusion matrices and the
  argmax equal except at pixels whose top-two JAX logits lie within
  1e-4 * max(1, |logit|) (ROADMAP C.3).
- validation's report text is byte-equal to JAX's for one confusion matrix.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2r_tpu.eval import metrics as JM
from s2r_tpu_torch.eval import metrics as PM

from _torch_port_common import HW, images, jax_deeplab, port_deeplab, \
    torch_threads

C = 19


def _labels(seed, shape=(2, 17, 23)):
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, C, shape).astype(np.int32)
    gt[rs.rand(*shape) < 0.1] = 255
    pred = rs.randint(0, C, shape).astype(np.int32)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_matrix_equals_jax(seed):
    gt, pred = _labels(seed)
    want = np.asarray(JM.confusion_matrix(jnp.asarray(gt), jnp.asarray(pred),
                                          C))
    got = PM.confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred), C)
    assert got.dtype == torch.int64 and got.shape == (C, C)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((gt != 255).sum())


@pytest.mark.parametrize("seed", [3, 4])
def test_evaluator_metrics_equal_jax(seed):
    jev, pev = JM.Evaluator(C), PM.Evaluator(C)
    for k in range(3):
        gt, pred = _labels(seed * 10 + k, (1, 9, 11))
        pred[pred == 7] = 3        # class 7 never predicted
        gt[gt == 5] = 255          # class 5 never present nor predicted:
        pred[pred == 5] = 3        # a NaN IoU
        jev.add_batch(gt, pred)
        pev.add_batch(gt, pred)
    np.testing.assert_array_equal(pev.confusion_matrix, jev.confusion_matrix)
    assert pev.Pixel_Accuracy() == jev.Pixel_Accuracy()
    assert pev.Pixel_Accuracy_Class() == jev.Pixel_Accuracy_Class()
    (pm, piou), (jm, jiou) = (pev.Mean_Intersection_over_Union(),
                              jev.Mean_Intersection_over_Union())
    assert pm == jm
    np.testing.assert_array_equal(piou, jiou)
    assert np.isnan(piou[5])
    assert (pev.Frequency_Weighted_Intersection_over_Union()
            == jev.Frequency_Weighted_Intersection_over_Union())


def test_merge_past_2_24_stays_exact():
    big = torch.zeros((C, C), dtype=torch.int64)
    big[0, 0] = 2 ** 24
    one = torch.zeros((C, C), dtype=torch.int64)
    one[0, 0] = 1
    ev = PM.Evaluator(C)
    ev.merge(big)
    for _ in range(3):
        ev.merge(one)
    assert ev.confusion_matrix[0, 0] == 2 ** 24 + 3
    assert ev._cm.dtype == torch.int64
    # the JAX package's float32 accumulator rounds the increments away
    jev = JM.Evaluator(C)
    jev.merge(jnp.asarray(big.numpy(), jnp.float32))
    for _ in range(3):
        jev.merge(jnp.asarray(one.numpy(), jnp.float32))
    assert jev.confusion_matrix[0, 0] != 2 ** 24 + 3


@pytest.fixture(scope="module")
def weights():
    return jax_deeplab()


def test_eval_step_matches_jax(weights):
    from s2r_tpu.train.losses import build_seg_loss as jax_loss
    from s2r_tpu.train.steps import make_eval_step as jax_eval_step
    from s2r_tpu_torch.train.losses import build_seg_loss
    from s2r_tpu_torch.train.steps import make_eval_step

    model, params, stats = weights
    x = images(2, HW, seed=5)
    rs = np.random.RandomState(6)
    label = rs.randint(0, C, (2, HW, HW)).astype(np.int32)
    label[:, :5] = 255
    j_loss, j_cm, j_pred = jax.jit(jax_eval_step(model, jax_loss("ce"), C))(
        params, stats, jnp.asarray(x), jnp.asarray(label))
    j_logits = np.asarray(model.apply({"params": params,
                                       "batch_stats": stats},
                                      jnp.asarray(x), False)[0])
    with torch_threads():
        port = port_deeplab(params, stats)
        port.train()  # the eval step must run in eval mode and restore this
        p_loss, p_cm, p_pred = make_eval_step(port, build_seg_loss("ce"), C)(
            x, label)
    assert port.training
    assert p_cm.dtype == torch.int64 and p_pred.shape == (2, HW, HW)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]
           <= 1e-4 * np.maximum(1.0, np.abs(top2[..., 1])))
    differ = p_pred.numpy() != np.asarray(j_pred)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    cm_l1 = np.abs(p_cm.numpy() - np.asarray(j_cm)).sum()
    assert cm_l1 <= 2 * int(tie.sum()), (cm_l1, int(tie.sum()))


def test_validation_report_is_byte_equal(tmp_path):
    from s2r_tpu.cli import _eval_common as JE
    from s2r_tpu.config import Config as JaxConfig
    from s2r_tpu_torch.cli import _eval_common as PE
    from s2r_tpu_torch.config import Config

    rs = np.random.RandomState(8)
    cm = rs.randint(0, 5000, (C, C)).astype(np.int64)
    cm[4, :] = 0     # class 4 absent and never predicted: NaN IoU
    cm[:, 4] = 0
    loss = np.float32(1.2345678)
    batch = {"image": np.zeros((1, 2, 2, 3), np.float32),
             "label": np.zeros((1, 2, 2), np.int32)}

    def j_step(params, bstats, image, label):
        return jnp.asarray(loss), jnp.asarray(cm, jnp.float32), None

    def p_step(image, label):
        return torch.tensor(loss), torch.from_numpy(cm), None

    j_path, p_path = tmp_path / "j" / "val_info.txt", tmp_path / "p" / "v.txt"
    j_miou, j_iou = JE.validation(JaxConfig(), None, None, j_step, [batch],
                                  C, str(j_path))
    model = types.SimpleNamespace(device=torch.device("cpu"))
    p_miou, p_iou = PE.validation(Config(), model, p_step, [batch], C,
                                  str(p_path))
    assert p_path.read_bytes() == j_path.read_bytes()
    assert p_miou == j_miou
    np.testing.assert_array_equal(p_iou, j_iou)
