"""--remat in the port (models/layers.py ``remat``) against the same steps
without it, on the CPU in float32.

The JAX package's recompute changes no numerics (tests/test_remat.py:
rtol 1e-5, atol 1e-6 on losses, parameters and statistics after one
output step).  The port's step is held to those bounds, for the output
and the feature step at 32x32 batch 2 with dropout on, and bit-equal on
what a resumed run must find equal: every num_batches_tracked, the
dropout generator's state, and the masks drawn (each mask a recompute
draws is one its forward drew).  Three traps would break that, each with
a check here that fails without its fix:

- a recompute that took BatchNorm statistics again would update the
  running statistics and num_batches_tracked a second time;
- a recompute that drew dropout masks from the step's generator would
  draw new masks (a wrong gradient) and advance the generator twice;
- under data parallel, a recompute that took statistics again would
  all-reduce them again: the step keeps its 248 all-reduces (a mesh of two
  whose all-reduce is the identity counts them).

Also: the kernels a step calls (depthwise 56 + 28 recomputed, BatchNorm
apply 120 + 118, the others as without remat), ResNet-50 (ASPP and the
decoder recomputed, the backbone not), and the identity without
gradients.
"""

import collections

import numpy as np
import pytest
import torch

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core.mesh import Mesh
from s2r_tpu_torch.models import layers as L
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.ops.kernels import batchnorm as B
from s2r_tpu_torch.ops.kernels import depthwise as D
from s2r_tpu_torch.train import setup as S

from _torch_port_common import torch_threads

HW, N = 32, 2
COUNTED = ((B, "batch_norm_stats"), (B, "batch_norm_apply"),
           (B, "batch_norm_grad_sums"), (B, "batch_norm_dx"),
           (D, "depthwise_conv3x3"), (D, "depthwise_dk"))


def _batch(method):
    rs = np.random.RandomState(0)
    return {"src_image": rs.randn(N, HW, HW, 3).astype(np.float32),
            "src_label": rs.randint(0, 19, (N, HW, HW)).astype(np.int64),
            "tgt_image": rs.randn(N, HW, HW, 3).astype(np.float32)}


class _CountingMesh(Mesh):
    """A mesh of two processes whose all-reduce is the identity: it counts
    the collectives a step issues without a process group."""

    def __init__(self):
        super().__init__(2, 0)

    def all_reduce_(self, t, op="sum"):
        self._count(t)
        return t


def _run(method, remat, monkeypatch, mesh=None):
    """One step of `method` at HW, batch N, f32 (with or without remat):
    (metrics, G and D state, generator state, masks drawn, calls of the
    counted functions, collectives)."""
    masks, calls = [], collections.Counter()
    draw = L.Dropout._draw

    def recording(*a):
        masks.append(draw(*a))
        return masks[-1]

    with monkeypatch.context() as mp:
        mp.setattr(L.Dropout, "_draw", staticmethod(recording))
        for mod, name in COUNTED:
            fn = getattr(mod, name)
            mp.setattr(mod, name,
                       lambda *a, _fn=fn, _n=name, **k: (
                           calls.update([_n]), _fn(*a, **k))[1])
        if mesh is not None:
            mp.setattr(S, "make_mesh", lambda n=None: mesh)
        m = S.build_method(Config(precision="f32", remat=remat,
                                  crop_size=HW, base_size=HW, batch_size=N),
                           10, method=method, device="cpu")
        assert m.deeplab.remat == remat
        state = m.init_state()
        with torch_threads():
            state, met = m.step_fn(state, _batch(method))
    sd = {**{"G." + k: v.clone() for k, v in state.G.state_dict().items()},
          **{"D." + k: v.clone() for k, v in state.D.state_dict().items()}}
    return ({k: float(v) for k, v in met.items()}, sd,
            state.generator.get_state(), masks, calls,
            None if mesh is None else mesh.calls)


@pytest.fixture(scope="module", params=["output_adapt", "feature_adapt"])
def runs(request):
    with pytest.MonkeyPatch.context() as mp:
        return request.param, _run(request.param, False, mp), \
            _run(request.param, True, mp)


def test_remat_step_matches_no_remat(runs):
    _, plain, re = runs
    for k in plain[0]:
        np.testing.assert_allclose(re[0][k], plain[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in plain[1].items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(re[1][k], v), k
        else:
            np.testing.assert_allclose(re[1][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert any(int(v) > 0 for k, v in plain[1].items()
               if k.endswith("num_batches_tracked"))


def test_remat_keeps_generator_and_masks(runs):
    method, plain, re = runs
    assert torch.equal(re[2], plain[2])
    n = len(plain[3])
    assert n == (6 if method == "output_adapt" else 10)
    forward, recomputed = re[3][:n], re[3][n:]
    assert all(torch.equal(a, b) for a, b in zip(forward, plain[3]))
    # every dropout under remat replays: ASPP's and the decoder's of both
    # forwards (the feature step's target decoder feeds no loss, so it is
    # not recomputed; the domain classifier is not wrapped)
    assert len(recomputed) == (6 if method == "output_adapt" else 4)
    assert all(any(torch.equal(r, f) for f in forward) for r in recomputed)


def test_remat_kernel_calls(runs):
    method, plain, re = runs
    feature = method == "feature_adapt"
    assert plain[4] == {
        "batch_norm_stats": 124 if feature else 120,
        "batch_norm_apply": 124 if feature else 120,
        "batch_norm_grad_sums": 121 if feature else 120,
        "batch_norm_dx": 121 if feature else 120,
        "depthwise_conv3x3": 56, "depthwise_dk": 28}
    # the recompute: every BatchNorm of the 17 blocks, ASPP and the
    # decoder applies again (59 a forward; the feature step's target
    # decoder is not recomputed), on the forward's statistics
    want = dict(plain[4], batch_norm_apply=plain[4]["batch_norm_apply"]
                + (115 if feature else 118),
                depthwise_conv3x3=56 + 28)
    assert re[4] == want


def test_remat_under_data_parallel_adds_no_all_reduce(monkeypatch):
    plain = _run("output_adapt", False, monkeypatch, _CountingMesh())
    re = _run("output_adapt", True, monkeypatch, _CountingMesh())
    # 248 and one: the count of D's real outputs over the mesh, which
    # normalizes the three BCE means (train/losses.py real_count)
    assert plain[5] == re[5] == 249
    for k in plain[0]:
        np.testing.assert_allclose(re[0][k], plain[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in plain[1].items():
        np.testing.assert_allclose(re[1][k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_remat_resnet50_wraps_aspp_and_decoder(monkeypatch):
    """The other backbones are not wrapped, ASPP and the decoder are: the
    gradients and the running statistics are those without remat, and
    only the 9 BatchNorms of ASPP and the decoder apply again."""
    x = torch.from_numpy(np.random.RandomState(1).randn(
        N, 3, HW, HW).astype(np.float32))
    out = {}
    for remat in (False, True):
        calls = collections.Counter()
        fn = B.batch_norm_apply
        monkeypatch.setattr(B, "batch_norm_apply", lambda *a: (
            calls.update(["apply"]), fn(*a))[1])
        model = DeepLab(backbone="resnet50", device="cpu", remat=remat,
                        generator=torch.Generator().manual_seed(0)).train()
        gen = torch.Generator().manual_seed(3)
        with torch_threads():
            logits, _ = model(x, generator=gen)
            grads = torch.autograd.grad((logits ** 2).mean(),
                                        list(model.parameters()))
        out[remat] = (grads, model.state_dict(), calls["apply"],
                      gen.get_state())
        monkeypatch.setattr(B, "batch_norm_apply", fn)
    assert out[True][2] == out[False][2] + 9 == 62 + 9
    assert torch.equal(out[True][3], out[False][3])
    for a, b in zip(out[True][0], out[False][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k


def test_remat_without_gradients_is_the_call():
    model = DeepLab(device="cpu", remat=True).train()
    x = torch.randn(1, 3, HW, HW)
    with torch.no_grad():
        got, _ = model(x, generator=torch.Generator().manual_seed(0))
    model.remat = model.backbone.remat = False
    with torch.no_grad():
        want, _ = model(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, want)
